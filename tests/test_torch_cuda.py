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


def _u16(t: torch.Tensor) -> torch.Tensor:
    """uint16 bits as int16, which every torch operation takes."""
    return t.view(torch.int16)


# stride 3 gives rows of n % 4 != 0 records, staged word by word
@pytest.mark.parametrize("depth,stride", [(16, 2), (8, 1), (12, 3), (4, 1)])
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
    before = S.KERNEL.launches, S.POS_KERNEL.launches
    got = S.select_candidates(sk, sb4, sb4b, depth)
    pos = S.select_to_positions(sk, sb4, sb4b, depth, n)
    assert (S.KERNEL.launches, S.POS_KERNEL.launches) == (before[0] + 1,
                                                          before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, S.select_candidates_ref(sk, sb4, sb4b, depth))
    assert torch.equal(_u16(pos), _u16(S.select_to_positions_ref(
        sk, sb4, sb4b, depth, n)))
    cpu = mf.find_candidates(data.cpu(), lens.cpu(), depth, stride=stride)
    assert torch.equal(_u16(mf.find_candidates(data, lens, depth,
                                               stride=stride).cpu()),
                       _u16(cpu))
    assert S.POS_KERNEL.launches == before[1] + 2


def test_select_kernel_refuses_other_depths(dev):
    from qatzip_tpu_torch.ops import select as S

    a = torch.full((2, 1024), -1, dtype=torch.int32, device=dev)
    before = S.KERNEL.launches, S.POS_KERNEL.launches
    for depth in (3, 17):
        with pytest.raises(ValueError, match="depth"):
            S.select_candidates(a, a, a, depth)
        with pytest.raises(ValueError, match="depth"):
            S.select_to_positions(a, a, a, depth, 1024)
    assert (S.KERNEL.launches, S.POS_KERNEL.launches) == before


@pytest.mark.parametrize("depth", [8, 12, 16])
def test_select_kernel_long_runs_and_invalid_tails(dev, depth):
    """Sorted rows of 40-record hash runs, positions over 64 K, invalid
    tails (the rows of the g++ shim's test, built here without numpy's
    help from the reference)."""
    from qatzip_tpu_torch.ops import select as S

    g = torch.Generator().manual_seed(depth)
    rows = []
    for tail in (0, 100, 1000):
        valid = 4096 - tail
        pos = torch.randperm(65536, generator=g)[:valid].sort().values
        h = torch.randint(0, 1 << 15, (-(-valid // 40),), generator=g)
        key = (h.sort().values.repeat_interleave(40)[:valid] << 16) | pos
        key = key.sort().values
        b4 = (torch.randint(0, 2, (valid,), generator=g) << 24) \
            | torch.randint(0, 3, (valid,), generator=g)
        b4b = torch.randint(0, 2, (valid,), generator=g)
        pad = torch.full((tail,), -1, dtype=torch.int64)
        rows.append([torch.cat([key, pad]), torch.cat([b4, pad * 0]),
                     torch.cat([b4b, pad * 0])])
    sk, sb4, sb4b = (torch.stack([r[i] for r in rows]).to(torch.int32)
                     .to(dev) for i in range(3))
    got = S.select_candidates(sk, sb4, sb4b, depth)
    pos = S.select_to_positions(sk, sb4, sb4b, depth, 65536)
    torch.cuda.synchronize()
    assert torch.equal(got, S.select_candidates_ref(sk, sb4, sb4b, depth))
    assert torch.equal(_u16(pos), _u16(S.select_to_positions_ref(
        sk, sb4, sb4b, depth, 65536)))
    assert int((got > 0).sum()) > 1000


def test_packed_candidates_on_cuda_equal_cpu(dev):
    from qatzip_tpu_torch.ops import match_finder as mf

    n = 16384
    datas = [_text(n, 3), bytes(n), _text(7000, 4)]
    arr = np.zeros((len(datas), n + 8), np.uint8)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
    data = torch.from_numpy(arr)
    lens = torch.tensor([len(d) for d in datas], dtype=torch.int32)
    for depth in (8, 16):
        got = mf.find_candidates_packed(data.to(dev), lens.to(dev), depth)
        assert torch.equal(got.cpu(), mf.find_candidates_packed(data, lens,
                                                                depth))


def test_calibrate_on_cuda(dev, monkeypatch, tmp_path):
    from qatzip_tpu_torch.engine import devcal

    monkeypatch.setenv("QATZIP_TPU_DEVCAL_PATH", str(tmp_path / "cal.json"))
    rec = devcal.calibrate(sample_bytes=1 << 20)
    assert "device_error" not in rec and "compute_probe_error" not in rec
    for k in ("dev_comp_gbps", "dev_comp_raw_gbps", "dev_comp_packed_gbps",
              "dev_decomp_gbps", "dev_decomp_compute_gbps",
              "dev_comp_compute_gbps"):
        assert rec[k] > 0, k
    assert devcal._load() == rec


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
        fail0, launches0 = ld.failover_blocks, S.POS_KERNEL.launches
        outs[device.type] = qt.compress(data, algorithm, hw_buff_sz=16384)
        assert qt.decompress(outs[device.type], algorithm,
                             hw_buff_sz=16384) == data
        assert core.engine().hw_requests - hw0 == 2 * -(-len(data) // 16384)
        assert core.engine().sw_requests == sw0
        assert ld.failover_blocks == fail0
    core.qz_close_engine()
    assert S.POS_KERNEL.launches == launches0 + 1
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


def _engine_on(device):
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import constants as C
    from qatzip_tpu_torch.engine import core

    core.qz_close_engine()
    assert qt.qz_init(qt.QzSession(), device=device) == C.QZ_OK
    return core.engine()


def _deflate_session(fmt):
    import qatzip_tpu_torch as qt

    sess = qt.QzSession()
    p = qt.QzSessionParamsDeflate(data_fmt=fmt)
    p.common_params.hw_buff_sz = 16384
    p.common_params.strm_buff_sz = 16384
    assert qt.qz_setup_session_deflate(sess, p) == qt.QZ_OK
    return sess


def _launches():
    from qatzip_tpu_torch.ops import inflate_kernel as K
    from qatzip_tpu_torch.ops import select as S

    return S.POS_KERNEL.launches, K.KERNEL.launches


def test_stream_on_cuda(dev, monkeypatch):
    """Stream compress (gzip-ext and 4B) and the 4B stream decompress on the
    card: the kernels launch, nothing runs on the software path, and the
    bytes equal the CPU device's."""
    from qatzip_tpu_torch import constants as C
    from qatzip_tpu_torch import stream as ST
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.ops import deflate_decode as dd

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    data = _text(200_000, 9)

    def feed(fn, sess, src):
        strm, out = ST.QzStream(), bytearray()
        for i in range(0, len(src), 30_000):
            rc, produced = fn(sess, strm, src[i:i + 30_000],
                              last=int(i + 30_000 >= len(src)))
            assert rc == C.QZ_OK
            out += produced
        return bytes(out + ST.qz_end_stream(sess, strm)[1])

    outs = {}
    for device in (torch.device("cpu"), dev):
        eng = _engine_on(device)
        sw0, fail0, launches0 = eng.sw_requests, dd.failover_lanes, \
            _launches()
        comps = [feed(ST.qz_compress_stream, _deflate_session(f), data)
                 for f in (C.QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                           C.QzDataFormat.QZ_DEFLATE_4B)]
        back = feed(ST.qz_decompress_stream,
                    _deflate_session(C.QzDataFormat.QZ_DEFLATE_4B), comps[1])
        assert back == data
        assert (eng.sw_requests, dd.failover_lanes) == (sw0, fail0)
        outs[device.type] = comps, _launches()
    core.qz_close_engine()
    assert outs["cuda"][0] == outs["cpu"][0]
    select, inflate = (b - a for a, b in zip(launches0, outs["cuda"][1]))
    assert select >= 2 * -(-len(data) // 16384) and inflate >= 1


def test_async_on_cuda(dev, monkeypatch):
    """qz_compress2/qz_decompress2 from two threads on the card: results
    in order, equal to one-shot results, no software execution."""
    import threading

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import async_api as A
    from qatzip_tpu_torch import constants as C
    from qatzip_tpu_torch.engine import core

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    slices = [_text(100_000, 20 + i) for i in range(4)]
    eng = _engine_on(dev)
    sess = _deflate_session(C.QzDataFormat.QZ_DEFLATE_GZIP_EXT)
    want = [qt.qz_compress(sess, s).data for s in slices]
    launches0, sw0 = _launches(), eng.sw_requests
    for fn, srcs, expect in ((A.qz_compress2, slices, want),
                             (A.qz_decompress2, want, slices)):
        futs = [None] * 4

        def submit(idx):
            for i in idx:
                rc, futs[i] = fn(sess, srcs[i])
                assert rc == C.QZ_OK

        threads = [threading.Thread(target=submit, args=(range(k, 4, 2),))
                   for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        results = [f.result(timeout=120) for f in futs]
        assert [r.data for r in results] == expect
        assert not any(r.ext_rc & C.QZ_SW_EXECUTION_MASK for r in results)
    qt.qz_close(sess)
    core.qz_close_engine()
    assert eng.sw_requests == sw0
    assert all(b > a for a, b in zip(launches0, _launches()))


def test_metadata_on_cuda(dev, monkeypatch):
    """The metadata API on the card: the tables equal the CPU device's, the
    decompress is exact in one device batch, no software execution."""
    import dataclasses

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import constants as C
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.ops import deflate_decode as dd

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    data = _text(300_000, 30)
    outs = {}
    for device in (torch.device("cpu"), dev):
        _engine_on(device)
        fail0 = dd.failover_lanes
        launches0 = _launches()
        _, blob = qt.qz_allocate_metadata(len(data), 16384)
        sess = _deflate_session(C.QzDataFormat.QZ_DEFLATE_GZIP_EXT)
        res = qt.qz_compress_with_metadata_ext(sess, data, blob)
        dres = qt.qz_decompress_with_metadata_ext(sess, res.data, blob)
        assert dres.data == data and dd.failover_lanes == fail0
        assert not (res.ext_rc | dres.ext_rc) & C.QZ_SW_EXECUTION_MASK
        outs[device.type] = (res.data, [dataclasses.asdict(b)
                                        for b in blob.blocks[:blob.valid]])
    core.qz_close_engine()
    assert outs["cuda"] == outs["cpu"]
    assert all(b > a for a, b in zip(launches0, _launches()))


# -- the construct probes' kernels (qatzip_tpu_torch/tools/probes.py) --------


def test_probe_library_builds(dev):
    from qatzip_tpu_torch.ops import _build

    _build.build(name=_build.PROBES)
    _build.library(_build.PROBES)


def _probe_check(dev, kernel, call, *cpu_args):
    """call(*args) on the card launches kernel once and equals call on the
    CPU copies (the plain versions)."""
    want = call(*cpu_args)
    before = kernel.launches
    got = call(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in cpu_args))
    assert kernel.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g.cpu(), w)


def _i32(rng, shape, lo=-2**31, hi=2**31):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                            .astype(np.int32))


# a table a row (the TPU shape), one 2048-word table for every row (the
# inflate's 8 KB a lane), one thread a row
@pytest.mark.parametrize("t_rows,w,n", [(16, 128, 128), (1, 2048, 300),
                                        (16, 2048, 1)])
@pytest.mark.parametrize("mode", ["dep", "indep4", "indep8"])
@pytest.mark.parametrize("smem", [True, False])
def test_probe_chain_rows_equal_plain(dev, mode, smem, t_rows, w, n):
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(w + n)
    t, idx = _i32(rng, (t_rows, w)), _i32(rng, (16, n))
    _probe_check(dev, P.CHAIN, lambda a, b: P.probe_chain(
        mode, a, b, 9, smem=smem), t, idx)


@pytest.mark.parametrize("n,rows,post", [(8, 8, 0xFFFFFFFF), (64, 1, 63),
                                         (512, 8, 511)])
@pytest.mark.parametrize("smem", [True, False])
def test_probe_chain_column_and_walk_equal_plain(dev, smem, n, rows, post):
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(n)
    t, idx = _i32(rng, (n, 128), 0, n), _i32(rng, (rows, 128), 0, n)
    _probe_check(dev, P.CHAIN, lambda a, b: P.probe_chain(
        "column", a, b, 11, smem=smem, post=post), t, idx)
    x = _i32(rng, (8, 128))
    _probe_check(dev, P.CHAIN, lambda a: P.probe_chain(
        "walk", a, None, 300, smem=smem), x)


@pytest.mark.parametrize("mode", ["hash", "ew", "double"])
def test_probe_alu_equals_plain(dev, mode):
    from qatzip_tpu_torch.tools import probes as P

    x = _i32(np.random.default_rng(1), (3, 1000))
    _probe_check(dev, P.ALU, lambda a: P.probe_alu(mode, a, 13), x)


@pytest.mark.parametrize("lpc", [1, 8, 32])
def test_probe_step_equals_plain(dev, lpc):
    """STEP3 on random int32 tables; STEP5 with and without its tokens at
    the TPU's root of 128 cells and the inflate's 256; TOKENS stored alone
    and through a tile (lanes a CTA a multiple of 4)."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(lpc)
    win, tll, td = (_i32(rng, (2, 128)) for _ in range(3))
    bp = _i32(rng, (2, 128), 0, 1 << 16)
    _probe_check(dev, P.STEP, lambda *a: P.probe_step(
        "step3", "none", *a, 20, lanes_per_cta=lpc), win, tll, td, bp)
    for rc in (128, 256):
        w5 = _i32(rng, (128, 64))
        t5, d5 = _i32(rng, (rc + 256, 64)), _i32(rng, (rc + 256, 64))
        b5 = _i32(rng, (1, 64), 0, 1000)
        for store in ("none", "lone"):
            _probe_check(dev, P.STEP, lambda *a: P.probe_step(
                "step5", store, *a, 10, lanes_per_cta=lpc, root_cells=rc,
                sub_cells=256), w5, t5, d5, b5)
    t = _i32(rng, (2, 128), 0, 3)
    i0 = _i32(rng, (2, 128), 0, 128)
    for store in (("lone", "tile") if lpc % 4 == 0 else ("lone",)):
        _probe_check(dev, P.STEP, lambda a, b: P.probe_step(
            "tokens", store, None, a, None, b, 16, lanes_per_cta=lpc,
            tile=8), t, i0)


@pytest.mark.parametrize("lpc", [64, 128])
def test_probe_tokens_tile_fits_wide_ctas(dev, lpc):
    """A CTA of 64 or 128 lanes stages one 384-word row and a [256][lpc]
    token tile: within the shared memory a CTA may take."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(lpc)
    t = _i32(rng, (2, 128), 0, 3)
    i0 = _i32(rng, (2, 128), 0, 128)
    for store in ("lone", "tile"):
        _probe_check(dev, P.STEP, lambda a, b: P.probe_step(
            "tokens", store, None, a, None, b, 512, lanes_per_cta=lpc,
            tile=256), t, i0)


def test_probe_tiles_equal_plain(dev):
    """ROLL on both axes, TRANSPOSE, REFILL by loads, cp.async and TMA (by
    offset and by block index), BITONIC on the three segment shapes."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(7)
    for S, shift, axis in ((16, 4, 0), (512, 448, 0), (8, 127, 1),
                           (512, -3, 1)):
        x = _i32(rng, (S, 128))
        _probe_check(dev, P.TILE, lambda a: P.probe_roll(a, shift, axis), x)
    x = _i32(rng, (128, 128))
    for K in (1, 2, 5):
        _probe_check(dev, P.TILE, lambda a: P.probe_transpose(a, K), x)
    stream = _i32(rng, (64, 1024))
    off = _i32(rng, (64,), 0, 1024 - 200)
    for how in ("ld", "cp", "tma"):
        for K, alt in ((1, 0), (4, 0), (3, 64)):
            _probe_check(dev, P.TILE, lambda a, b: P.probe_refill(
                a, b, 128, K, alt=alt, how=how), stream, off)
    x = _i32(rng, (5, 8, 128))
    for segment in ("flat", "rows", "cols"):
        _probe_check(dev, P.TILE, lambda a: P.probe_bitonic(a, segment, 2), x)


# ------------------------------------------- parity engines and parallel/
def _internal(algo, fmt=None):
    import qatzip_tpu_torch as qt

    return qt.api._session_for(algo, fmt, 1, 16384).params


@pytest.mark.parametrize("algo", ["deflate", "lz4"])
def test_device_encoder_on_cuda_equals_cpu(dev, monkeypatch, algo):
    """QATZIP_TPU_ENCODER=device: the codec's payloads and chunk checksums
    on the card equal the CPU device's."""
    import gzip

    from qatzip_tpu_torch.ops import device_codecs as dc

    monkeypatch.setenv("QATZIP_TPU_ENCODER", "device")
    data = _text(8 * 16384 - 100, 11)
    chunks = [data[i:i + 16384] for i in range(0, len(data), 16384)]
    codec = (dc.DeflateDeviceCodec() if algo == "deflate"
             else dc.Lz4DeviceCodec())
    params = _internal(algo)
    out = {d.type: codec.compress_chunks(chunks, params, d)
           for d in (torch.device("cpu"), dev)}
    assert out["cuda"] == out["cpu"]
    if algo == "deflate":
        for c, r in zip(chunks, out["cuda"]):
            assert zlib.decompressobj(-15).decompress(r.payload) == c
            assert r.checksum == zlib.crc32(c)


def test_spec_decoder_on_cuda_equals_cpu(dev, monkeypatch):
    from qatzip_tpu_torch.ops import deflate_decode as dd

    monkeypatch.setenv("QATZIP_TPU_INFLATE", "spec")
    datas = [_text(16384, s) for s in range(9)] + [b"A" * 20000, b""]
    payloads = []
    for d in datas:
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        payloads.append(co.compress(d) + co.flush())
    hints = [len(d) for d in datas]
    for kind in ("crc32", "adler32"):
        got = dd.inflate_batch(payloads, hints, dev, kind=kind)
        assert got == dd.inflate_batch(payloads, hints, torch.device("cpu"),
                                       kind=kind)
        assert [g[0] for g in got] == datas


def test_device_checksums_on_cuda(dev):
    from qatzip_tpu_torch.ops import checksums as ck

    rng = np.random.default_rng(3)
    n = 65536
    lens = [0, 1, 3, 4, 127, 128, 129, n - 1, n] + list(
        rng.integers(0, n, 23))
    data = torch.from_numpy(rng.integers(0, 256, (len(lens), n),
                                         dtype=np.uint8)).to(dev)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    host = data.cpu().numpy()
    assert ck.crc32_blocks(data, lt, n).cpu().tolist() == [
        zlib.crc32(host[i, :k].tobytes()) for i, k in enumerate(lens)]
    assert ck.adler32_blocks(data, lt, n).cpu().tolist() == [
        zlib.adler32(host[i, :k].tobytes()) for i, k in enumerate(lens)]


def test_compress_blocks_sharded_on_cuda(dev):
    from qatzip_tpu_torch.ops import deflate_encode as de
    from qatzip_tpu_torch.parallel import shard

    n, b = 16384, 8
    blob = _text(n * b, 12)
    data = np.zeros((b, n + 8), np.uint8)
    data[:, :n] = np.frombuffer(blob, np.uint8).reshape(b, n)
    lens = np.full(b, n, np.int32)
    words, bits, mode = shard.compress_blocks_sharded([dev], data, lens)
    assert [w.device for w in words] == [dev]
    w1, b1, m1 = de.encode_blocks(data, lens, 1, 16, True, de.words_bound(n),
                                  device=torch.device("cpu"))
    assert torch.equal(words[0].cpu(), w1) and torch.equal(bits[0].cpu(), b1)
    assert (mode == m1).all()


def test_graft_entry_on_cuda(dev):
    from qatzip_tpu_torch import graft_entry
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.ops import select as S

    n0 = S.POS_KERNEL.launches
    fn, args = graft_entry.entry()
    assert args[0].device == dev and fn(*args).shape == (8, 4096)
    assert S.POS_KERNEL.launches > n0
    core.qz_close_engine()
    try:
        graft_entry.dryrun_multichip(1)
    finally:
        core.qz_close_engine()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        graft_entry.dryrun_multichip(torch.cuda.device_count() + 1)


def test_two_ranks_share_the_card(dev):
    """Two ranks of the worker on the device route on the card: the
    distributed stream equals the single-process one, each rank launches
    the kernels."""
    import os
    import re

    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.tools import dist_worker

    _build.library()   # built once here, not by both ranks
    outs = dist_worker.launch(["--device", "cuda"],
                              env=dict(os.environ, QATZIP_TPU_FORCE_SW="0"),
                              timeout=300)
    for out in outs:
        m = re.search(r"DIST DEVICE OK rank=\d hw=\d+ select=(\d+) "
                      r"inflate=(\d+)", out)
        assert m and int(m.group(1)) >= 1 and int(m.group(2)) >= 1, out[-2000:]


# ---------------------------------------------------------------------------
# LZ4 / LZ4s block decode kernel (csrc/lz4_block.cu)
# ---------------------------------------------------------------------------
def _lz4_sets():
    """(name, blocks, lz4s) groups: corpus blocks, LZ4s blocks above 64 KB,
    the edge cases of tools/lz4_cases.py and mutated corpus blocks."""
    from qatzip_tpu_torch.engine.lz4_block import (lz4_block_compress,
                                                   lz4s_block_compress)
    from qatzip_tpu_torch.tools import lz4_cases as LC

    rng = np.random.default_rng(12)
    texts = [_text(n, s) for n, s in ((100, 1), (7000, 2), (30000, 3))]
    texts += [bytes(3000), rng.integers(0, 256, 2000, np.uint8).tobytes()]
    big = [rng.integers(0, 256, 1 << 16, np.uint8).tobytes(),
           _text(1 << 16, 4)]
    sets = []
    for lz4s in (False, True):
        comp = ((lambda d: lz4s_block_compress(d, 3)) if lz4s
                else lz4_block_compress)
        good = [comp(d) for d in texts]
        fuzz = [LC.mutate(good[i % 3], LC.random_mutations(rng))
                for i in range(48)]
        edges = [b for _, b in LC.edge_blocks()]
        sets += [("corpus", good, lz4s), ("edges", edges, lz4s),
                 ("fuzz", fuzz, lz4s)]
    sets.append(("lz4s above 64 KB", [lz4s_block_compress(d, 3)
                                      for d in big], True))
    return sets


def _lz4_group(blocks, dev):
    from qatzip_tpu_torch.ops import lz4_decode as ld

    n = ld._next_pow2(max(len(b) for b in blocks) + 8, 1024)
    arr = np.zeros((len(blocks), n), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    return torch.from_numpy(arr).to(dev), lens.to(dev), n


@pytest.mark.parametrize("case", range(7))
def test_lz4_kernel_equals_plain(dev, case):
    """The kernel against the plain version on the same tensors on the
    card: every row's err, and tot and bytes where it is clear; a clear
    row's bytes are the host decoder's."""
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import lz4_kernel as LK
    from qatzip_tpu_torch.tools import lz4_cases as LC

    name, blocks, lz4s = _lz4_sets()[case]
    b, lens, n = _lz4_group(blocks, dev)
    got = [t.cpu() for t in LK.decode(b, lens, n, ld.MAX_OUT, lz4s, 2)]
    want = [t.cpu() for t in ld._decode_blocks_impl(b, lens, n, ld.MAX_OUT,
                                                     lz4s, 2)]
    assert torch.equal(got[2], want[2]), name
    for r, blk in enumerate(blocks):
        if not bool(got[2][r]):
            t = int(got[1][r])
            assert t == int(want[1][r])
            assert torch.equal(got[0][r, :t], want[0][r, :t]), (name, r)
            assert got[0][r, :t].numpy().tobytes() == LC.host_decode(
                blk, lz4s, 2, ld.MAX_OUT)
    if name in ("corpus", "lz4s above 64 KB"):
        assert not bool(got[2].any())
    elif name == "fuzz":
        assert 0 < int(got[2].sum()) < len(blocks)


def test_lz4_decode_blocks_launches_once_a_group(dev, monkeypatch):
    """decode_blocks on cuda:0 launches the kernel once a group of GROUP
    blocks and never runs the plain version."""
    from qatzip_tpu_torch.engine.lz4_block import lz4_block_compress
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import lz4_kernel as LK

    plain = []
    impl = ld._decode_blocks_impl
    monkeypatch.setattr(ld, "_decode_blocks_impl",
                        lambda *a: plain.append(1) or impl(*a))
    datas = [_text(4096, s) for s in range(ld.GROUP + 5)]
    blocks = [lz4_block_compress(d) for d in datas]
    launches = LK.KERNEL.launches
    assert ld.decode_blocks(blocks, device=dev) == datas
    assert LK.KERNEL.launches - launches == 2
    assert not plain


def test_lz4_kernel_unbuildable_library_raises(dev, monkeypatch, tmp_path):
    """A kernel library that does not compile raises KernelError from
    decode_blocks: nothing falls back to the plain version or the CPU."""
    import shutil

    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import lz4_kernel as LK

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    (src / "lz4_block.cu").write_text((src / "lz4_block.cu").read_text()
                                      + "\nthis is not C++;\n")
    monkeypatch.setitem(_build.LIBRARIES, _build.KERNELS, (str(src), "*.cu"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(LK, "KERNEL", _build.Kernel(LK.KERNEL.symbol,
                                                    LK.KERNEL.argtypes))
    fail0 = ld.failover_blocks
    with pytest.raises(_build.KernelError, match="nvcc failed"):
        ld.decode_blocks([b"\x10a"], device=dev)
    assert ld.failover_blocks == fail0 and LK.KERNEL.launches == 0


_TRAP_CHILD = r"""
import json, os, re, shutil, sys, tempfile
import torch
import qatzip_tpu_torch as qt
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.ops import _build, lz4_decode as ld
from qatzip_tpu_torch.ops import lz4_kernel as LK

# a copy of the kernels whose LZ4 kernel traps on entry
tmp = tempfile.mkdtemp()
src = os.path.join(tmp, "csrc")
shutil.copytree(_build.CSRC, src)
path = os.path.join(src, "lz4_block.cu")
text = open(path).read()
head = "qz_lz4_kernel(QzLz4Args a) {"
assert text.count(head) == 1
open(path, "w").write(text.replace(head, head + " __trap();"))
_build.LIBRARIES[_build.KERNELS] = (src, "*.cu")
_build.BUILD_DIR = os.path.join(tmp, "build")

os.environ["QATZIP_TPU_DEVICE"] = "1"
assert qt.qz_init(qt.QzSession(), device=torch.device("cuda", 0)) == 0
data = bytes(range(256)) * 4096 + b"tail" * 5000
comp = qt.compress(data, "lz4", hw_buff_sz=65536, sw_only=True)
eng = core.engine()
before = (eng.sw_requests, health.total_failures, ld.failover_blocks)
try:
    qt.decompress(comp, "lz4", hw_buff_sz=65536)
    caught = None
except Exception as exc:
    caught = (type(exc).__name__, str(exc)[:300])
after = (eng.sw_requests, health.total_failures, ld.failover_blocks)
print("TRAP " + json.dumps({"caught": caught, "before": before,
                            "after": after, "launches": LK.KERNEL.launches}))
sys.stdout.flush()
os._exit(0)
"""


def test_lz4_kernel_fault_reaches_the_caller(dev, tmp_path):
    """A kernel that really faults on the card (a __trap() at its entry, in
    a copy of the sources built in a child process, whose context the
    fault poisons): the LZ4 decompress through the API raises KernelError
    or the CUDA error, with no CPU rerun, no health failure and no
    failed-over block."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TRAP_CHILD], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=root))
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TRAP ")]
    assert line, proc.stdout[-2000:] + proc.stderr[-4000:]
    rec = json.loads(line[0][5:])
    assert rec["caught"] is not None, rec
    kind, msg = rec["caught"]
    assert kind in ("KernelError", "AcceleratorError") or (
        kind == "RuntimeError" and "CUDA error" in msg), rec
    assert rec["launches"] == 1, rec
    assert rec["after"] == rec["before"], rec
