"""QATzip's LZ4 offload on the port's normal path against the benchmark's
plain reference.

The deployment is ``qzbench/configs/lz4_l1.json``: ``qz_setup_session_lz4``
at level 1, each chunk one LZ4 frame of one block with its content size
and XXH32 content checksum (FLG 0x4C).  Its plain reference is
``qzbench/refs/lz4_frame.py`` with ``qzbench/lz4plain.py`` (torch and
numpy, nothing of the program).  Here the port runs with the device route
forced on ``torch.device("cpu")`` (the block decoder's plain version), at
16 KB chunks: one chunk from each of the nine segments of the benchmark's
corpus (``qzbench/corpus.py``), so that the request holds stored chunks
(base64, x-ray) and high-ratio ones (markup, logs, sparse).
"""
import json
import os
import struct

import pytest
import torch

import qatzip_tpu_torch as qt
from qatzip_tpu_torch.ops import lz4_decode as ld
from qzbench import corpus, lz4plain, xxh32
from qzbench.refs import lz4_frame
from torch_conformance import engine_on, port_engine  # noqa: F401

torch.set_num_threads(1)

CHUNK = 16 << 10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [2**31 + 101, 2**32 + 7, 918273645]


def _session():
    """The configuration's session, its chunk cut to ``CHUNK``."""
    with open(os.path.join(ROOT, "qzbench", "configs", "lz4_l1.json")) as f:
        spec = json.load(f)["session"]
    common = qt.QzSessionParamsCommon(**dict(spec["common"],
                                             hw_buff_sz=CHUNK))
    params = getattr(qt, spec["params"])(common_params=common,
                                         **spec["fields"])
    sess = qt.QzSession()
    assert getattr(qt, spec["setup"])(sess, params) == qt.QZ_OK
    return sess


def _original(seed):
    """A chunk from the start of each corpus segment, for ``seed``."""
    data = corpus.build(seed, 0, 9 * corpus.SEG_SZ)
    return b"".join(data[k * corpus.SEG_SZ:k * corpus.SEG_SZ + CHUNK]
                    for k in range(9))


def _frames(stream):
    """(FLG, content size, stored, block size) of each one-block frame."""
    out, pos = [], 0
    while pos < len(stream):
        assert struct.unpack_from("<I", stream, pos)[0] == lz4plain.MAGIC
        flg = stream[pos + 4]
        size = struct.unpack_from("<Q", stream, pos + 6)[0]
        (word,) = struct.unpack_from("<I", stream, pos + 15)
        ln = word & ~lz4plain.STORED
        pos += 19 + ln
        assert struct.unpack_from("<I", stream, pos)[0] == 0   # endmark
        pos += 8                                              # + checksum
        out.append((flg, size, bool(word & lz4plain.STORED), ln))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_reads_the_reference_frames(port_engine, seed):
    original = _original(seed)
    stream = lz4_frame.make(original, CHUNK)
    frames = _frames(stream)
    assert len(frames) == 9 and {f[0] for f in frames} == {0x4C}
    assert all(size == CHUNK for _, size, _, _ in frames)
    # stored chunks and high-ratio ones, beside the rest
    assert sum(st for _, _, st, _ in frames) >= 1
    assert any(not st and size >= 3 * ln for _, size, st, ln in frames)
    hw0, sw0 = port_engine.hw_requests, port_engine.sw_requests
    fail0, dev0, st0 = ld.failover_blocks, ld.device_blocks, ld.stored_blocks
    res = qt.qz_decompress(_session(), stream)
    assert res.rc == qt.QZ_OK and not res.ext_rc & qt.QZ_SW_EXECUTION_MASK
    assert res.consumed == len(stream)
    assert res.data == original
    assert res.crc == xxh32.xxh32(original)
    # every frame on the device route, its compressed block decoded there
    assert port_engine.hw_requests - hw0 == 9
    assert port_engine.sw_requests == sw0 and ld.failover_blocks == fail0
    stored = sum(st for _, _, st, _ in frames)
    assert (ld.device_blocks - dev0, ld.stored_blocks - st0) == (
        9 - stored, stored)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_reads_the_port_frames(port_engine, seed):
    original = _original(seed)
    res = qt.qz_compress(_session(), original)
    assert res.rc == qt.QZ_OK and not res.ext_rc & qt.QZ_SW_EXECUTION_MASK
    frames = _frames(res.data)
    assert len(frames) == 9 and {f[0] for f in frames} == {0x4C}
    assert any(st for _, _, st, _ in frames)
    assert lz4_frame.read(res.data) == original
