"""The port's metadata (block-index) API against the reference's.

The same inputs go through both packages with the device route forced
(the port's engine on ``torch.device("cpu")``, the kernels' plain
versions): the frameless payload stream, every block table entry and
CRC, and the return codes must be equal; the decompress must take every
deflate block in one device batch and fail no lane over.  One deliberate
divergence: a ``KernelError`` or ``NotImplementedError`` raised by the
device backend reaches the caller instead of falling back to the CPU.
"""
import contextlib
import dataclasses
import zlib

import numpy as np
import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu_torch import metadata as M
from qatzip_tpu_torch.engine.faults import InjectedFault
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.utils import checksum as ck
from tests.test_torch_api_ext import port  # noqa: F401

torch.set_num_threads(1)

HW_BUFF = 16 << 10
PKGS = {"ref": qatzip_tpu, "port": qt}
XZ = dict(initial_value=(1 << 64) - 1, reflect_in=1, reflect_out=1,
          xor_out=(1 << 64) - 1)
MPEG = dict(polynomial=0x04C11DB7, initial_value=0, reflect_in=0,
            reflect_out=0, xor_out=0)


def session(qz, fmt=C.QzDataFormat.QZ_DEFLATE_GZIP_EXT, crc32=None,
            crc64=None):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate(data_fmt=fmt)
    p.common_params.hw_buff_sz = HW_BUFF
    assert qz.qz_setup_session_deflate(sess, p) == C.QZ_OK
    if crc32:
        assert qz.qz_set_session_crc32_config(
            sess, qz.Crc32Config(**crc32)) == C.QZ_OK
    if crc64:
        assert qz.qz_set_session_crc64_config(
            sess, qz.Crc64Config(**crc64)) == C.QZ_OK
    return sess


def table(blob) -> list[dict]:
    return [dataclasses.asdict(b) for b in blob.blocks[:blob.valid]]


def compress_both(data, blk=HW_BUFF, **kw):
    """(result, blob) of each package on the same input."""
    out = {}
    for name, qz in PKGS.items():
        rc, blob = qz.qz_allocate_metadata(len(data), blk)
        assert rc == C.QZ_OK
        out[name] = (qz.qz_compress_with_metadata_ext(
            session(qz, **kw), data, blob), blob)
    return out


@contextlib.contextmanager
def one_device_batch(monkeypatch):
    """Records the lanes of each device inflate batch; no lane may fail
    over and no failure be recorded."""
    batches = []
    inflate = dd.inflate_batch

    def counted(payloads, *a, **kw):
        batches.append(len(payloads))
        return inflate(payloads, *a, **kw)

    monkeypatch.setattr(dd, "inflate_batch", counted)
    fail0, failures0 = dd.failover_lanes, health.total_failures
    yield batches
    assert (dd.failover_lanes, health.total_failures) == (fail0, failures0)


def test_round_trip_equals_reference_in_one_device_batch(corpus_factory,
                                                         port, monkeypatch):
    data = corpus_factory(150_000)
    got = compress_both(data)
    (res, blob), (ref, ref_blob) = got["port"], got["ref"]
    assert res.rc == C.QZ_OK and not res.ext_rc & C.QZ_SW_EXECUTION_MASK
    assert (res.data, res.crc, res.consumed) == (ref.data, ref.crc,
                                                 ref.consumed)
    assert table(blob) == table(ref_blob)
    assert blob.valid == blob.block_count == -(-len(data) // HW_BUFF)
    assert len(res.data) < len(data)

    with one_device_batch(monkeypatch) as batches:
        dres = qt.qz_decompress_with_metadata_ext(session(qt), res.data, blob)
    assert dres.rc == C.QZ_OK and not dres.ext_rc & C.QZ_SW_EXECUTION_MASK
    deflate = sum(b["flags"] & M.QZ_METADATA_BLOCK_DEFLATE
                  for b in table(blob)) // M.QZ_METADATA_BLOCK_DEFLATE
    assert batches == [deflate]
    assert dres.data == data and dres.crc == zlib.crc32(data)
    ref_d = qatzip_tpu.qz_decompress_with_metadata_ext(
        session(qatzip_tpu), ref.data, ref_blob)
    assert (dres.rc, dres.crc, dres.consumed) == (ref_d.rc, ref_d.crc,
                                                  ref_d.consumed)


@pytest.mark.parametrize("fmt", [C.QzDataFormat.QZ_DEFLATE_GZIP,
                                 C.QzDataFormat.QZ_DEFLATE_4B,
                                 C.QzDataFormat.QZ_DEFLATE_RAW])
def test_other_deflate_formats_give_the_reference_tables(corpus_factory,
                                                         port, fmt):
    data = corpus_factory(40_000)
    got = compress_both(data, fmt=fmt)
    assert got["port"][0].data == got["ref"][0].data
    assert table(got["port"][1]) == table(got["ref"][1])


def test_random_access_block_equals_reference(corpus_factory, port):
    data = corpus_factory(60_000)
    got = compress_both(data)
    (res, blob), (ref, ref_blob) = got["port"], got["ref"]
    k = blob.valid // 2
    read = qt.qz_metadata_block_read(k, blob)
    assert read == qatzip_tpu.qz_metadata_block_read(k, ref_blob)
    rc, off, size, flags, block_hash = read
    assert rc == C.QZ_OK and flags & M.QZ_METADATA_BLOCK_DEFLATE
    out = zlib.decompressobj(-15).decompress(res.data[off:off + size])
    assert out == data[k * HW_BUFF:(k + 1) * HW_BUFF]
    assert block_hash == zlib.crc32(out)


def test_stored_blocks_and_threshold_equal_reference(corpus_factory, port):
    """Incompressible blocks are stored raw; a comp_thrshold and a block
    size override change the tables as in the reference."""
    rnd = np.random.default_rng(0).integers(0, 256, 40_000, np.uint8)
    data = rnd.tobytes() + corpus_factory(40_000)
    got = compress_both(data)
    assert got["port"][0].data == got["ref"][0].data
    flags = [b["flags"] for b in table(got["port"][1])]
    assert flags[:2] == [M.QZ_METADATA_BLOCK_STORED] * 2
    assert flags[-1] == M.QZ_METADATA_BLOCK_DEFLATE
    assert table(got["port"][1]) == table(got["ref"][1])
    for kw in ({"comp_thrshold": 4000}, {"hw_buff_sz_override": 8192}):
        out = {}
        for name, qz in PKGS.items():
            _, blob = qz.qz_allocate_metadata(len(data), 8192)
            res = qz.qz_compress_with_metadata_ext(session(qz), data, blob,
                                                   **kw)
            out[name] = (res.rc, res.data, res.crc, table(blob))
        assert out["port"] == out["ref"]
    stored = compress_both(rnd.tobytes())["port"]
    dres = qt.qz_decompress_with_metadata_ext(session(qt), stored[0].data,
                                              stored[1])
    assert dres.rc == C.QZ_OK and dres.data == rnd.tobytes()


@pytest.mark.parametrize("configs", [{}, {"crc32": MPEG, "crc64": XZ}])
def test_block_crcs_equal_reference(corpus_factory, port, configs):
    data = corpus_factory(50_000)
    got = compress_both(data, **configs)
    blob, ref_blob = got["port"][1], got["ref"][1]
    for k in range(blob.valid + 1):
        for fn in ("qz_metadata_block_get_crc32",
                   "qz_metadata_block_get_crc64"):
            assert getattr(qt, fn)(k, blob) == getattr(qatzip_tpu, fn)(
                k, ref_blob)
    cfg32 = qt.Crc32Config(**configs.get("crc32", {}))
    cfg64 = qt.Crc64Config(**configs.get("crc64", {}))
    _, in32, _ = qt.qz_metadata_block_get_crc32(0, blob)
    _, in64, out64 = qt.qz_metadata_block_get_crc64(0, blob)
    assert in32 == ck.crc32_configured(data[:HW_BUFF], cfg32)
    assert in64 == ck.crc64(data[:HW_BUFF], cfg64)
    _, off, size, _, _ = qt.qz_metadata_block_read(0, blob)
    assert out64 == ck.crc64(got["port"][0].data[off:off + size], cfg64)


def _lz4_session(qz):
    sess = qz.QzSession()
    assert qz.qz_setup_session_lz4(sess) == C.QZ_OK
    return sess


def _blob(qz, n=100, blk=64):
    return qz.qz_allocate_metadata(n, blk)[1]


_RC_CASES = {
    "allocate, negative size": lambda qz: qz.qz_allocate_metadata(-1, 64)[0],
    "allocate, zero block": lambda qz: qz.qz_allocate_metadata(10, 0)[0],
    "allocate, block too large": lambda qz: qz.qz_allocate_metadata(
        10, C.QZ_HW_BUFF_MAX_SZ + 1)[0],
    "free None": lambda qz: qz.qz_free_metadata(None),
    "free": lambda qz: qz.qz_free_metadata(_blob(qz)),
    "read past valid": lambda qz: qz.qz_metadata_block_read(99, _blob(qz)),
    "read, not a blob": lambda qz: qz.qz_metadata_block_read(0, object()),
    "write and read back": lambda qz: (
        qz.qz_metadata_block_write(0, b := _blob(qz), 0, 10, 1, 0x1DEAD),
        qz.qz_metadata_block_read(0, b)),
    "write past the blocks": lambda qz: qz.qz_metadata_block_write(
        2, _blob(qz), 0, 1, 1, 0),
    "crc32, negative block": lambda qz: qz.qz_metadata_block_get_crc32(
        -1, _blob(qz)),
    "overflow": lambda qz: qz.qz_compress_with_metadata_ext(
        session(qz), b"x" * 4096, _blob(qz, 1000, 512),
        hw_buff_sz_override=512).rc,
    "block override too large": lambda qz: qz.qz_compress_with_metadata_ext(
        session(qz), b"x" * 10, _blob(qz),
        hw_buff_sz_override=C.QZ_HW_BUFF_MAX_SZ + 1).rc,
    "compress, lz4 session": lambda qz: qz.qz_compress_with_metadata_ext(
        _lz4_session(qz), b"x" * 100, _blob(qz)).rc,
    "compress, no blob": lambda qz: qz.qz_compress_with_metadata_ext(
        session(qz), b"x", None).rc,
    "decompress, empty blob": lambda qz: qz.qz_decompress_with_metadata_ext(
        session(qz), b"x", _blob(qz)).rc,
    "decompress, span past the source": lambda qz: (
        qz.qz_metadata_block_write(0, b := _blob(qz), 5, 10, 1, 0),
        qz.qz_decompress_with_metadata_ext(session(qz), b"x" * 12, b).rc),
    "decompress, stored hash mismatch": lambda qz: (
        qz.qz_metadata_block_write(0, b := _blob(qz), 0, 4,
                                   M.QZ_METADATA_BLOCK_STORED, 7),
        qz.qz_decompress_with_metadata_ext(session(qz), b"abcd", b).rc),
}


@pytest.mark.parametrize("case", list(_RC_CASES))
def test_return_codes_equal_reference(port, case):
    got = {name: _RC_CASES[case](qz) for name, qz in PKGS.items()}
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("device_route", [True, False])
@pytest.mark.parametrize("corruption", ["flipped byte", "bad block type"])
def test_corrupt_payload_handled_as_reference(corpus_factory, port,
                                              monkeypatch, device_route,
                                              corruption):
    """A corrupted deflate payload.  A flipped byte inside a block still
    inflates, to the wrong bytes: QZ_DATA_ERROR on either route.  A block
    of the invalid type 3: QZ_DATA_ERROR on the CPU route; on the device
    route the lane fails over and zlib refuses it: the reference reruns
    the batch on the CPU, whose inflate lets zlib's error out, and the port
    returns QZ_DATA_ERROR with no rerun (ROADMAP queue 3)."""
    if not device_route:
        monkeypatch.setenv("QATZIP_TPU_DEVICE", "0")
    data = corpus_factory(40_000)
    got = compress_both(data)
    out = {}
    for name, qz in PKGS.items():
        res, blob = got[name]
        bad = bytearray(res.data)
        if corruption == "flipped byte":
            bad[len(bad) // 2] ^= 0xFF
        else:
            bad[blob.blocks[1].offset] |= 0x06
        try:
            out[name] = qz.qz_decompress_with_metadata_ext(
                session(qz), bytes(bad), blob).rc
        except zlib.error as exc:
            out[name] = type(exc)
    raises = device_route and corruption == "bad block type"
    assert out["ref"] == (zlib.error if raises else C.QZ_DATA_ERROR)
    assert out["port"] == C.QZ_DATA_ERROR


@pytest.mark.parametrize("exc", [_build.KernelError("nvcc not found"),
                                 NotImplementedError("unported option"),
                                 RuntimeError("device lost"),
                                 InjectedFault("injected submit fault")])
@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_kernel_errors_reach_the_caller(corpus_factory, port, monkeypatch,
                                        direction, exc):
    """The port's divergence: any error from the device backend but an
    injected fault or a card out of memory (a KernelError, a
    NotImplementedError, a RuntimeError) propagates out of both entry
    points; an injected fault falls back to the CPU with the software mask,
    as the reference's does with every error."""
    data = corpus_factory(30_000)
    _, blob = qt.qz_allocate_metadata(len(data), HW_BUFF)
    res = qt.qz_compress_with_metadata_ext(session(qt), data, blob)

    def fail(*args):
        raise exc

    monkeypatch.setattr(port.hw_backend, f"{direction}_chunks", fail)
    sw0 = port.sw_requests

    def call():
        if direction == "compress":
            return qt.qz_compress_with_metadata_ext(session(qt), data, blob)
        return qt.qz_decompress_with_metadata_ext(session(qt), res.data, blob)

    if type(exc) is InjectedFault:
        out = call()
        assert out.rc == C.QZ_OK and out.ext_rc & C.QZ_SW_EXECUTION_MASK
        if direction == "compress":   # the CPU's payloads, one a block
            out = M.OpResult(data=b"".join(
                zlib.decompressobj(-15).decompress(out.data[o:o + n])
                for _, o, n, _, _ in map(qt.qz_metadata_block_read,
                                         range(blob.valid),
                                         [blob] * blob.valid)))
        assert out.data == data
    else:
        with pytest.raises(type(exc), match=str(exc)):
            call()
    assert port.sw_requests == sw0
