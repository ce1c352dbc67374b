"""The reference's corruption fuzz (tests/test_fuzz.py) against the port.

Seeded mutations of valid streams (point mutations, truncation, a spliced
window) must give clean codes, and an accepted decode of a CRC-protected
format must be a prefix of the input.  Beside that class, the port's code
and output equal the reference's on every mutated buffer.

The device-path case keeps the reference's 20 trials of 1-3 point
mutations but over 16 KB of text at 8 KB chunks (the reference: 100 KB at
64 KB): the port's plain inflate on the CPU costs ~1 ms a step, and 20
trials at the reference's size would take ~150 s.  Beside the API calls,
the 20 mutated buffers' members go through one ``inflate_batch`` round in
each package: the same lanes fail over.  The LZ4 case also holds the
port's block decoder to the reference's on every mutated block.  The
full-size fuzz runs on the card (chip_smoke.py, step 8).
"""
import numpy as np
import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu.ops import deflate_decode as ref_dd
from qatzip_tpu.ops import lz4_decode as ref_ld
from qatzip_tpu_torch.formats import gzip_fmt
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import lz4_decode as ld
from tests.torch_conformance import (  # noqa: F401 (fixtures)
    both, engine_on, port_engine, refused, route, same)

torch.set_num_threads(1)

CPU = torch.device("cpu")
_OK_CODES = {qt.QZ_OK, qt.QZ_DATA_ERROR, qt.QZ_BUF_ERROR, qt.QZ_FAIL}


def _mk_sess(qz, fmt, hw_buff_sz=None):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.comp_lvl = 1
    if hw_buff_sz:
        p.common_params.hw_buff_sz = hw_buff_sz
    p.data_fmt = fmt
    assert qz.qz_setup_session_deflate(sess, p) == qt.QZ_OK
    return sess


def _lz4_sess(qz):
    sess = qz.QzSession()
    assert qz.qz_setup_session_lz4(sess, qz.QzSessionParamsLZ4()) == qt.QZ_OK
    return sess


def _check_class(data, res, crc_protected=True):
    assert res.rc in _OK_CODES, res.rc
    if res.rc == qt.QZ_OK and crc_protected:
        assert data.startswith(res.data), "accepted corrupt data"


@pytest.mark.parametrize("fmt", [QzDataFormat.QZ_DEFLATE_GZIP,
                                 QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                                 QzDataFormat.QZ_DEFLATE_4B])
def test_corruption_fuzz_deflate_formats(engine_on, corpus_factory, fmt):
    engine_on(CPU)
    rng = np.random.default_rng(hash(fmt) & 0xFFFF)
    data = corpus_factory(120_000, "text")
    ref_c, port_c = both(lambda qz: qz.qz_compress(_mk_sess(qz, fmt),
                                                   data).data)
    assert port_c == ref_c
    comp = bytearray(port_c)
    for trial in range(60):
        buf = bytearray(comp)
        kind = trial % 3
        if kind == 0:    # point mutations
            for _ in range(int(rng.integers(1, 5))):
                buf[int(rng.integers(0, len(buf)))] ^= int(
                    rng.integers(1, 256))
        elif kind == 1:  # truncation
            buf = buf[:int(rng.integers(1, len(buf)))]
        else:            # splice a random window over a random offset
            w = int(rng.integers(4, 64))
            src = int(rng.integers(0, len(buf) - w))
            dst = int(rng.integers(0, len(buf) - w))
            buf[dst:dst + w] = buf[src:src + w]
        ref, port = both(lambda qz: qz.qz_decompress(_mk_sess(qz, fmt),
                                                     bytes(buf)))
        # DEFLATE_4B carries no checksum: rc class only for it
        _check_class(data, port, fmt != QzDataFormat.QZ_DEFLATE_4B)
        same(ref, port, (fmt, trial))


def test_corruption_fuzz_lz4(engine_on, corpus_factory):
    engine_on(CPU)
    rng = np.random.default_rng(99)
    data = corpus_factory(100_000, "text")
    ref_c, port_c = both(lambda qz: qz.qz_compress(_lz4_sess(qz), data).data)
    assert port_c == ref_c
    comp = bytearray(port_c)
    blocks = []
    for trial in range(40):
        buf = bytearray(comp)
        if trial % 2 == 0:
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(0, len(buf)))] ^= int(
                    rng.integers(1, 256))
        else:
            buf = buf[:int(rng.integers(1, len(buf)))]
        ref, port = both(lambda qz: qz.qz_decompress(_lz4_sess(qz),
                                                     bytes(buf)))
        _check_class(data, port)
        same(ref, port, trial)
        blocks += _lz4_blocks(bytes(buf))
    # the mutated frames' compressed blocks through both block decoders:
    # the same blocks fail over, the others decode to the same bytes
    blocks0 = ld.failover_blocks
    out = ld.decode_blocks(blocks, device=CPU)
    assert out == ref_ld.decode_blocks(blocks)
    assert ld.failover_blocks - blocks0 == out.count(None) > 0


def _lz4_blocks(frame: bytes) -> list:
    """The compressed blocks of every frame of an LZ4 stream, as far as its
    block headers can be walked."""
    import struct

    blocks, pos = [], 0
    while pos + 15 <= len(frame) and frame[pos:pos + 4] == \
            b"\x04\x22\x4d\x18":
        pos += 15
        while pos + 4 <= len(frame):
            (size,) = struct.unpack_from("<I", frame, pos)
            pos += 4
            if size == 0:
                pos += 4
                break
            raw = size & 0x7FFFFFFF
            if not size & 0x80000000 and pos + raw <= len(frame) \
                    and raw <= ld.MAX_BLOCK:
                blocks.append(frame[pos:pos + raw])
            pos += raw
    return blocks


def test_corruption_fuzz_device_path(port_engine, corpus_factory):
    """The lockstep device decode forced: the kernel's plain version (or
    its per-lane failover) gives the reference's codes and output, and no
    trial reruns a batch on the CPU: where zlib refuses a lane that failed
    over, the reference's rerun sets the software mask and the port's
    request ends with the same QZ_DATA_ERROR without it."""
    rng = np.random.default_rng(7)
    data = corpus_factory(16_384, "text")
    fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    hw = 8192
    ref_c, port_c = both(lambda qz: qz.qz_compress(_mk_sess(qz, fmt, hw),
                                                   data).data)
    assert port_c == ref_c
    comp = bytearray(port_c)
    payloads, hints = [], []
    n_refused = 0
    # a trial whose lane fails over and that zlib then refuses counts no
    # device request (it ends at that chunk): the route is checked over all
    # 20
    with route(device=True, failover_ok=True):
        for trial in range(20):
            buf = bytearray(comp)
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(0, len(buf)))] ^= int(
                    rng.integers(1, 256))
            port = qt.qz_decompress(_mk_sess(qt, fmt, hw), bytes(buf))
            ref = qatzip_tpu.qz_decompress(_mk_sess(qatzip_tpu, fmt, hw),
                                           bytes(buf))
            _check_class(data, port)
            same(ref, port, trial, refused_ok=True)
            assert not port.ext_rc & qt.QZ_SW_EXECUTION_MASK
            n_refused += refused(ref, port)
            for off, length, hint in _members(bytes(buf)):
                payloads.append(bytes(buf[off:off + length]))
                hints.append(hint)
    # one round for the lanes of all 20 buffers in each package
    lanes0 = dd.failover_lanes
    out = dd.inflate_batch(payloads, hints, CPU, kind="crc32")
    assert out == ref_dd.inflate_batch(payloads, hints, kind="crc32")
    assert dd.failover_lanes - lanes0 == out.count(None) > 0
    assert n_refused > 0


def _members(buf: bytes):
    """(payload offset, length, size hint) of each gzip-ext member whose
    header still parses and whose payload lies inside the buffer."""
    pos = 0
    while True:
        ext = gzip_fmt.parse_gzipext_header(buf, pos)
        if ext is None:
            return
        off = pos + gzip_fmt.GZIPEXT_HEADER_SIZE
        if off + ext.dest_sz > len(buf) or ext.src_sz > 1 << 16:
            return
        yield off, ext.dest_sz, ext.src_sz
        pos = off + ext.dest_sz + 8
