"""The port's LZ4 frame and LZ4s block device path against the reference.

Compress: with the device route forced in both packages, the port's bytes
equal qatzip_tpu's (the same match finder and native emitter).  Decompress:
``lz4_decode.decode_blocks`` and ``_decode_blocks_impl`` equal the JAX
decoder exactly, bytes, ``None`` pattern and raw arrays; the API round trip
decodes every block on the device, with none failed over to the CPU.  The
port's engine runs on ``torch.device("cpu")``, the seam that runs the plain
torch code.
"""
import numpy as np
import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu.engine.lz4_block import (lz4_block_compress,
                                         lz4s_block_compress)
from qatzip_tpu.ops import lz4_decode as rld
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.ops import lz4_decode as ld

torch.set_num_threads(1)

HW_BUFF = 16 << 10
CPU = torch.device("cpu")


@pytest.fixture
def cpu_engine(monkeypatch):
    """The port's engine on the CPU device with the device route forced."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    core.qz_close_engine()
    sess = qt.QzSession()
    assert qt.qz_init(sess, device=torch.device("cpu")) == C.QZ_OK
    yield core.engine()
    core.qz_close_engine()


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("kind", ["text", "constant", "random"])
@pytest.mark.parametrize("algorithm", ["lz4", "lz4s"])
def test_bytes_equal_reference_and_round_trip(corpus_factory, cpu_engine,
                                              algorithm, kind, level):
    data = corpus_factory(40_000, kind)
    hw0, sw0 = cpu_engine.hw_requests, cpu_engine.sw_requests
    fail0, failures0 = ld.failover_blocks, health.total_failures

    comp = qt.compress(data, algorithm, level=level, hw_buff_sz=HW_BUFF)
    assert comp == qatzip_tpu.compress(data, algorithm, level=level,
                                       hw_buff_sz=HW_BUFF)
    assert qt.decompress(comp, algorithm, hw_buff_sz=HW_BUFF) == data
    assert qt.decompress(comp, algorithm, hw_buff_sz=HW_BUFF,
                         sw_only=True) == data

    nchunks = -(-len(data) // HW_BUFF)
    assert cpu_engine.hw_requests - hw0 == 2 * nchunks
    assert cpu_engine.sw_requests - sw0 == nchunks    # the sw_only read
    assert ld.failover_blocks == fail0
    assert health.total_failures == failures0


@pytest.mark.parametrize("size", [1, 12, 13, 64, 4096])
def test_tiny_inputs_equal_reference(corpus_factory, cpu_engine, size):
    data = corpus_factory(size, "random")
    comp = qt.compress(data, "lz4", hw_buff_sz=HW_BUFF)
    assert comp == qatzip_tpu.compress(data, "lz4", hw_buff_sz=HW_BUFF)
    assert qt.decompress(comp, "lz4", hw_buff_sz=HW_BUFF) == data


def test_device_encoder_option_raises(corpus_factory, cpu_engine,
                                      monkeypatch):
    """QATZIP_TPU_ENCODER=device runs the device encoder's LZ4 branch: the
    reference's bytes, on the device route, and they round-trip."""
    monkeypatch.setenv("QATZIP_TPU_ENCODER", "device")
    data = corpus_factory(20_000)
    hw0, sw0 = cpu_engine.hw_requests, cpu_engine.sw_requests
    comp = qt.compress(data, "lz4", hw_buff_sz=HW_BUFF)
    assert cpu_engine.hw_requests - hw0 == -(-len(data) // HW_BUFF)
    assert cpu_engine.sw_requests == sw0
    assert comp == qatzip_tpu.compress(data, "lz4", hw_buff_sz=HW_BUFF)
    assert qt.decompress(comp, "lz4", hw_buff_sz=HW_BUFF, sw_only=True) == data


def _lz4s_blocks(corpus_factory):
    datas = [corpus_factory(s, k) for s, k in
             [(100, "text"), (30_000, "text"), (10_000, "constant"),
              (5_000, "random")]]
    return [lz4s_block_compress(d, 3) for d in datas], datas


def test_decode_blocks_equal_reference(corpus_factory):
    """The cases of test_device_lz4.py: LZ4s blocks, a zero offset, a
    60 KB run, plus an empty and an oversize block."""
    blocks, datas = _lz4s_blocks(corpus_factory)
    got = ld.decode_blocks(blocks, mini_match=3, device=CPU)
    assert got == rld.decode_blocks(blocks, mini_match=3)
    assert got == datas

    good = b"\x54abcde\x05\x00\x50XYZWQ"
    bad_zero_off = b"\x54abcde\x00\x00\x50XYZWQ"
    run = lz4_block_compress(b"A" * 60000)
    lz4 = [good, bad_zero_off, run, b""]
    fail0 = ld.failover_blocks
    got = ld.decode_blocks(lz4, device=CPU)
    assert got == rld.decode_blocks(lz4)
    assert got[0] == b"abcdeabcdeabcXYZWQ" and got[2] == b"A" * 60000
    assert [g is None for g in got] == [False, True, False, True]
    assert ld.failover_blocks - fail0 == 2


def test_decode_takes_blocks_above_64k_unlike_reference(corpus_factory):
    """The port's one divergence in decode_blocks: an LZ4s block of an
    incompressible 64 KB chunk (over the reference's 64 KB MAX_BLOCK)
    decodes on the device; a block over the port's MAX_BLOCK does not."""
    data = corpus_factory(1 << 16, "random")
    blk = lz4s_block_compress(data, 3)
    assert rld.MAX_BLOCK < len(blk) <= ld.MAX_BLOCK
    assert rld.decode_blocks([blk], mini_match=3) == [None]
    assert ld.decode_blocks([blk, bytes(ld.MAX_BLOCK + 1)],
                            mini_match=3, device=CPU) == [data, None]


def test_decode_groups_do_not_change_bytes(corpus_factory, monkeypatch):
    blocks, datas = _lz4s_blocks(corpus_factory)
    monkeypatch.setattr(ld, "GROUP", 3)
    assert ld.decode_blocks(blocks, mini_match=3,
                            device=CPU) == datas


@pytest.mark.parametrize("lz4s", [False, True])
def test_decode_impl_arrays_equal_reference(corpus_factory, lz4s):
    import jax.numpy as jnp

    datas = [corpus_factory(700, "text"), corpus_factory(300, "iterative"),
             corpus_factory(500, "constant")]
    blocks = [lz4s_block_compress(d, 3) if lz4s else lz4_block_compress(d)
              for d in datas]
    blocks.append(b"\x54abcde\x00\x00\x50XYZWQ")     # zero offset
    blocks.append(b"\x14a\x05\x00")                 # offset before start
    n = 1024
    arr = np.zeros((8, n), np.uint8)                 # 3 padding rows
    lens = np.zeros(8, np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    base = 2 if lz4s else 0
    want = rld._decode_blocks_impl(jnp.asarray(arr), jnp.asarray(lens), n,
                                   ld.MAX_OUT, lz4s, base)
    got = ld._decode_blocks_impl(torch.from_numpy(arr),
                                 torch.from_numpy(lens), n, ld.MAX_OUT, lz4s,
                                 base)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not got[2][:3].any() and got[2][3:5].all()


def test_decode_flags_what_the_reference_misses():
    """The plain decoder's two repairs over the reference (ops/
    lz4_decode.py's docstring).  A block whose last sequence is cut short
    is flagged, where the reference returns bytes the host decoder
    refuses; and an LZ4s sequence that adds no bytes no longer sends the
    bytes after it to the wrong sequence."""
    from qatzip_tpu_torch.engine.lz4_block import (lz4_block_decompress,
                                                   lz4s_block_decompress)

    truncated = [b"\x14a\x01", b"\x54abcde\x05", b"\x90abc"]
    assert all(r is not None for r in rld.decode_blocks(truncated))
    for blk in truncated:
        with pytest.raises(ValueError):
            lz4_block_decompress(blk, ld.MAX_OUT)
    assert ld.decode_blocks(truncated, device=CPU) == [None] * 3

    empty_seq = (b"\x20ab\x01\x00" + b"\x10c\x01\x00" + b"\x00\x01\x00"
                 + b"\x01\x03\x00" + b"\x10z")
    want = lz4s_block_decompress(empty_seq, ld.MAX_OUT, 3)
    assert want == b"abcabcz"
    assert rld.decode_blocks([empty_seq], mini_match=3) != [want]
    assert ld.decode_blocks([empty_seq], mini_match=3, device=CPU) == [want]


def test_kernel_wrapper_refuses_cpu_tensors():
    """ops/lz4_kernel.decode launches only on CUDA tensors: handed CPU ones
    it raises, and decode_blocks on the CPU never reaches it."""
    from qatzip_tpu_torch.ops import lz4_kernel
    from qatzip_tpu_torch.ops._build import KernelError

    b = torch.zeros((1, 1024), dtype=torch.uint8)
    with pytest.raises(KernelError, match="CUDA tensors"):
        lz4_kernel.decode(b, torch.zeros(1, dtype=torch.int32), 1024,
                          ld.MAX_OUT, False, 0)
    launches = lz4_kernel.KERNEL.launches
    assert ld.decode_blocks([b"\x10a"], device=CPU) == [b"a"]
    assert lz4_kernel.KERNEL.launches == launches


def test_sequence_count_equals_the_host_walk(corpus_factory):
    """tools/lz4_cases.count_sequences, which chip_smoke divides the
    kernel's time by, counts the sequences engine/lz4_block's LZ4s walk
    finds (LZ4 has the same grammar)."""
    from qatzip_tpu_torch.engine.lz4_block import lz4s_decode_sequences
    from qatzip_tpu_torch.tools import lz4_cases as LC

    for kind in ("text", "random", "constant"):
        blk = lz4s_block_compress(corpus_factory(30_000, kind), 3)
        assert LC.count_sequences(blk) == len(lz4s_decode_sequences(blk, 3))
    assert LC.count_sequences(lz4_block_compress(b"A" * 60000)) == 2
