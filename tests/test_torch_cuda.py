"""The port's CUDA kernels on the card, against their plain torch versions.

Marked ``cuda``: each test skips without a CUDA device.  On a CUDA host
without nvcc the build test fails, naming the gap.  The GPU host has no
jax, so this file imports none and needs none of conftest.py; run it there
from the repository root with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import random
import zlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _text(n: int, seed: int) -> bytes:
    rng = random.Random(seed)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
             b"dog", b"compression", b"hardware", b"offload"]
    out = bytearray()
    while len(out) < n:
        out += rng.choice(words) + b" " + bytes([rng.randrange(256)])
    return bytes(out[:n])


def test_kernels_build(dev):
    from qatzip_tpu_torch.ops import _build

    _build.build()
    _build.library()


@pytest.mark.parametrize("depth,stride", [(16, 2), (8, 1), (4, 3)])
def test_select_kernel_equals_plain(dev, depth, stride):
    from qatzip_tpu_torch.ops import match_finder as mf
    from qatzip_tpu_torch.ops import select as S

    n = 16384
    datas = [_text(n, 1), bytes(n), _text(5000, 2)]
    arr = np.zeros((len(datas), n + 8), np.uint8)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
    data = torch.from_numpy(arr).to(dev)
    lens = torch.tensor([len(d) for d in datas], dtype=torch.int32,
                        device=dev)
    sk, sb4, sb4b = mf.sorted_records(data, lens, stride, True)
    before = S.KERNEL.launches
    got = S.select_candidates(sk, sb4, sb4b, depth)
    assert S.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, S.select_candidates_ref(sk, sb4, sb4b, depth))
    cpu = mf.find_candidates(data.cpu(), lens.cpu(), depth, stride=stride)
    assert torch.equal(mf.find_candidates(data, lens, depth,
                                          stride=stride).cpu(), cpu)


# one lane; more lanes than a warp has; the reference's round; the port's
# round (DeflateDeviceCodec.LOCKSTEP_BATCH)
@pytest.mark.parametrize("lanes", [1, 33, 128, 512])
def test_inflate_kernel_equals_plain(dev, lanes):
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.ops import inflate as PI
    from qatzip_tpu_torch.ops import inflate_kernel as K

    assert dc.DeflateDeviceCodec.LOCKSTEP_BATCH == 512
    streams = []
    for i in range(lanes):
        data = _text(2000 + 97 * (i % 13), 10 + i % 7)
        co = zlib.compressobj(1 + i % 9, zlib.DEFLATED, -15)
        s = dd._Stream(co.compress(data) + co.flush(), len(data), i)
        assert dd._parse_one_header(s) == "huff"
        streams.append(s)
    live, inputs = dd.pack_round(streams)
    words, bit0, nbits, tll, td, active, max_steps = inputs
    words = words.copy()
    words[lanes // 2, 10:20] ^= 0x5A5A5A5A     # one lane corrupted
    t = PI.upload(words, bit0, nbits, tll, td, active, dev)
    before = K.KERNEL.launches
    got = PI.decode_lockstep(*t, max_steps)
    assert K.KERNEL.launches == before + 1
    want = PI._decode_ref(*t, max_steps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1].sum()) <= 1


# one CTA (1024); clusters of 2 CTAs (32768 with 2 payloads, 16384 with 4)
# and of 4 (65536); a row beyond one cluster (262144 with 2 payloads)
@pytest.mark.parametrize("B,n,npay", [(4, 1024, 0), (4, 1024, 2),
                                      (128, 32768, 2), (128, 65536, 2),
                                      (4, 16384, 4), (2, 262144, 2)])
def test_sort_kernel_equals_plain(dev, B, n, npay):
    from qatzip_tpu_torch.ops import sort as S

    rng = np.random.default_rng(n + npay)
    # unique keys across the whole u32 range: a random permutation of the
    # row's indices in the low bits, random high bits above them
    lo = np.argsort(rng.random((B, n)), axis=1).astype(np.uint64)
    hi = rng.integers(0, (1 << 32) // n, (B, n), dtype=np.uint64)
    keys = (hi * n + lo).astype(np.uint32).view(np.int32)
    pays = [rng.integers(-2**31, 2**31, (B, n), dtype=np.int64)
            .astype(np.int32) for _ in range(npay)]
    t = [torch.from_numpy(a).to(dev) for a in (keys, *pays)]
    before = S.KERNEL.launches
    got = S.sort_u32(*t)
    assert S.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    want = S.sort_u32_ref(*t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(S.sort_u32_ref(*(x.cpu() for x in t)), want):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("algorithm", ["lz4", "lz4s"])
def test_lz4_round_trip_on_cuda(dev, monkeypatch, algorithm):
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import constants as C
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import select as S

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    data = _text(300_000, 8)
    outs = {}
    for device in (torch.device("cpu"), dev):
        core.qz_close_engine()
        sess = qt.QzSession()
        assert qt.qz_init(sess, device=device) == C.QZ_OK
        hw0, sw0 = core.engine().hw_requests, core.engine().sw_requests
        fail0, launches0 = ld.failover_blocks, S.KERNEL.launches
        outs[device.type] = qt.compress(data, algorithm, hw_buff_sz=16384)
        assert qt.decompress(outs[device.type], algorithm,
                             hw_buff_sz=16384) == data
        assert core.engine().hw_requests - hw0 == 2 * -(-len(data) // 16384)
        assert core.engine().sw_requests == sw0
        assert ld.failover_blocks == fail0
    core.qz_close_engine()
    assert S.KERNEL.launches == launches0 + 1
    assert outs["cuda"] == outs["cpu"]
    assert qt.decompress(outs["cuda"], algorithm, hw_buff_sz=16384,
                         sw_only=True) == data


def test_slice_on_cuda(dev, monkeypatch):
    import gzip

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import constants as C
    from qatzip_tpu_torch.engine import core

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    data = _text(300_000, 7)
    outs = {}
    for device in (torch.device("cpu"), dev):
        core.qz_close_engine()
        sess = qt.QzSession()
        assert qt.qz_init(sess, device=device) == C.QZ_OK
        outs[device.type] = qt.compress(data, level=1, hw_buff_sz=16384)
        assert qt.decompress(outs[device.type], hw_buff_sz=16384) == data
    core.qz_close_engine()
    assert outs["cuda"] == outs["cpu"]
    assert gzip.decompress(outs["cuda"]) == data
