"""The port's CUDA kernels on the card, against their plain torch versions.

Marked ``cuda``: each test skips without a CUDA device.  On a CUDA host
without nvcc the build test fails, naming the gap.  The GPU host has no
jax, so this file imports none and needs none of conftest.py; run it there
from the repository root with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os
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
# inflate's 8 KB a lane), one thread a row; INDEP stages 128-word rows 32
# times over, 2048-word rows 16 times, a 32768-word row once, and 2-word
# rows a word at a time
@pytest.mark.parametrize("t_rows,w,n", [(16, 128, 128), (1, 2048, 300),
                                        (16, 2048, 1), (1, 128, 64),
                                        (16, 2048, 40), (16, 2, 50),
                                        (1, 32768, 33)])
@pytest.mark.parametrize("mode", ["dep", "indep4", "indep8"])
@pytest.mark.parametrize("smem", [True, False])
def test_probe_chain_rows_equal_plain(dev, mode, smem, t_rows, w, n):
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(w + n)
    t, idx = _i32(rng, (t_rows, w)), _i32(rng, (16, n))
    if mode != "dep":
        assert P.indep_copies(w, int(mode[-1])) == {
            128: 32, 2048: 16, 2: 32, 32768: 1}[w]
    _probe_check(dev, P.DEP if mode == "dep" else P.INDEP,
                 lambda a, b: P.probe_chain(mode, a, b, 9, smem=smem), t, idx)


# the TPU probes' heights (8, 64, 128, 512) and more: 128 rows to 1024,
# one to four tensor-copy boxes of 256 rows, 1 to 32 index rows
@pytest.mark.parametrize("n,rows,post", [(8, 8, 0xFFFFFFFF), (64, 1, 63),
                                         (128, 1, 127), (256, 3, 255),
                                         (512, 8, 511), (1024, 32, 1023),
                                         (1024, 4, 0xFFFFFFFF)])
@pytest.mark.parametrize("smem", [True, False])
def test_probe_chain_column_and_walk_equal_plain(dev, smem, n, rows, post):
    """COLUMN through its own entry (qz_probe_column) and WALK: one launch
    each, equal to plain, the table's values over the whole int32 range."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(n + rows)
    t, idx = _i32(rng, (n, 128)), _i32(rng, (rows, 128))
    _probe_check(dev, P.COLUMN, lambda a, b: P.probe_chain(
        "column", a, b, 11, smem=smem, post=post), t, idx)
    x = _i32(rng, (8, 128))
    _probe_check(dev, P.CHAIN, lambda a: P.probe_chain(
        "walk", a, None, 300, smem=smem), x)


@pytest.mark.parametrize("mode", ["hash", "ew", "double", "shfl", "bar"])
def test_probe_alu_equals_plain(dev, mode):
    from qatzip_tpu_torch.tools import probes as P

    x = _i32(np.random.default_rng(1), (3, 1000))
    _probe_check(dev, P.ALU, lambda a: P.probe_alu(mode, a, 13), x)


@pytest.mark.parametrize("lpc", [1, 2, 4, 8, 16, 32, 64, 128])
def test_probe_step_equals_plain(dev, lpc):
    """STEP3 on random int32 tables at every lanes a CTA (a CTA of 128
    threads staging); STEP5 with and without its tokens at the TPU's root
    of 128 cells and the inflate's 256 (1, 8 or 32 lanes a CTA); TOKENS
    stored alone and through a tile (lanes a CTA a multiple of 4), over
    five tiles so that each of the two buffers is reused."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(lpc)
    win, tll, td = (_i32(rng, (2, 128)) for _ in range(3))
    bp = _i32(rng, (2, 128), 0, 1 << 16)
    _probe_check(dev, P.STEP, lambda *a: P.probe_step(
        "step3", "none", *a, 20, lanes_per_cta=lpc), win, tll, td, bp)
    for rc in ((128, 256) if lpc in P.STEP5_LPC else ()):
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
            "tokens", store, None, a, None, b, 40, lanes_per_cta=lpc,
            tile=8), t, i0)


@pytest.mark.parametrize("lpc", [64, 128])
def test_probe_tokens_tile_fits_wide_ctas(dev, lpc):
    """A CTA of 64 or 128 lanes stages one 384-word row and two token
    buffers, [256][64] each, or [128][128] at 128 lanes (two of 256 rows
    do not fit): within the shared memory a CTA may take; three tiles."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(lpc)
    t = _i32(rng, (2, 128), 0, 3)
    i0 = _i32(rng, (2, 128), 0, 128)
    assert P.tokens_rows(256, lpc) == (256 if lpc == 64 else 128)
    for store in ("lone", "tile"):
        _probe_check(dev, P.STEP, lambda a, b: P.probe_step(
            "tokens", store, None, a, None, b, 768, lanes_per_cta=lpc,
            tile=256), t, i0)


def test_probe_tiles_equal_plain(dev):
    """ROLL on both axes, TRANSPOSE (clusters of 1, 4 and 16 CTAs; a tile
    of n < 4, padded, and one that is not 16-byte aligned, copied first),
    REFILL by loads, cp.async and TMA (by offset and by block index; the
    offsets stay on the CPU), BITONIC on the three segment shapes at K 1,
    2 and 5 over several tiles of 64 to 4096 elements (the TPU probes'
    [8, 128], one segment of 4096, segments of 2 at two slots a
    thread)."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(7)
    for S, shift, axis in ((16, 4, 0), (512, 448, 0), (8, 127, 1),
                           (512, -3, 1)):
        x = _i32(rng, (S, 128))
        _probe_check(dev, P.ROLL, lambda a: P.probe_roll(a, shift, axis), x)
    flat = _i32(rng, (128 * 128 + 1,))   # a tile one word past 16 bytes
    for n in (2, 8, 32, 64, 128):
        x = _i32(rng, (n, n))
        for K in (1, 2, 5):
            _probe_check(dev, P.TRANSPOSE,
                         lambda a: P.probe_transpose(a, K), x)
    for K in (1, 2, 5):
        _probe_check(dev, P.TRANSPOSE, lambda a: P.probe_transpose(
            a[1:].view(128, 128), K), flat)
    stream = _i32(rng, (64, 1024))
    off = _i32(rng, (64,), 0, 1024 - 200)
    for how in ("ld", "cp", "tma"):
        for K, alt in ((1, 0), (4, 0), (3, 64), (2, 3)):
            _probe_check(dev, P.REFILL, lambda a: P.probe_refill(
                a, off, 128, K, alt=alt, how=how), stream)
    odd = _i32(rng, (64, 1021))   # rows not 16-byte aligned: a word a thread
    _probe_check(dev, P.REFILL, lambda a: P.probe_refill(a, off, 61, 3,
                                                         alt=5), odd)
    for shape in ((5, 8, 128), (3, 8, 8), (7, 64, 1), (2, 64, 64),
                  (4, 32, 128), (3, 512, 8), (2, 2, 2048), (2, 4, 8),
                  (3, 16, 64)):
        x = _i32(rng, shape)
        for segment in ("flat", "rows", "cols"):
            for K in (1, 2, 5):
                _probe_check(dev, P.TILE, lambda a: P.probe_bitonic(
                    a, segment, K), x)


def test_probe_roll_and_refill_sync_free_and_graph_replayed(dev):
    """ROLL and REFILL raise nothing under sync debug mode "error", are
    captured in a CUDA graph and replay equal to plain; a refill refuses
    offsets on the card and windows outside the stream before launching."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(8)
    rolls = [(_i32(rng, (S, 128)).to(dev), shift, axis)
             for S, shift, axis in ((512, 64, 0), (16, 1, 0), (8, 1, 1),
                                    (40, 127, 1))]
    stream = _i32(rng, (128, 256 * 64)).to(dev)
    off = _i32(rng, (128,), 0, 254) * 64
    refills = [(how, K, alt) for how in ("ld", "cp", "tma")
               for K, alt in ((1, 0), (2, 64), (5, 64))]

    def calls():
        return ([P.probe_roll(x, shift, axis) for x, shift, axis in rolls]
                + [P.probe_refill(stream, off, 128, K, alt=alt, how=how)
                   for how, K, alt in refills])

    want = ([P.roll(x.cpu(), shift, axis) for x, shift, axis in rolls]
            + [P._refill(stream.cpu(), off, 128, K, alt)
               for how, K, alt in refills])
    before = P.ROLL.launches, P.REFILL.launches
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = calls()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert (P.ROLL.launches, P.REFILL.launches) == (
        before[0] + 2 * len(rolls), before[1] + 2 * len(refills))
    for o in captured:
        o.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    for a, b, w in zip(got, captured, want, strict=True):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)
    launches = P.REFILL.launches
    with pytest.raises(ValueError, match="offsets on the CPU"):
        P.probe_refill(stream, off.to(dev), 128)
    with pytest.raises(ValueError, match="outside its stream"):
        P.probe_refill(stream, off + 64 * 128, 128)
    assert P.REFILL.launches == launches


def test_probe_transpose_and_dep_sync_free_and_graph_replayed(dev):
    """TRANSPOSE and DEP (p_gather's tables, [8, 1024] a cluster of 8 CTAs
    a row; one-row tables, staged once a cluster along the rows; the
    inflate's 8 KB rows; rows wider than a cluster of 128-thread CTAs;
    through shared memory and __ldg) raise nothing under sync debug mode
    "error", are captured in a CUDA graph and replay equal to plain; the
    [128, 128] transpose runs as a cluster of 16 CTAs on more than one SM
    (each CTA writes its SM into clk)."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(9)
    tiles = [(_i32(rng, (n, n)).to(dev), K)
             for n, K in ((128, 1), (128, 5), (64, 2), (8, 3))]
    deps = [(_i32(rng, (8, w), 0, 1 << 20).to(dev),
             _i32(rng, (8, w), 0, w).to(dev), 1, True) for w in (128, 1024)]
    deps += [(_i32(rng, (1, 1024)).to(dev), _i32(rng, (512, 128)).to(dev), 1,
              True),
             (_i32(rng, (512, 2048)).to(dev), _i32(rng, (512, 1)).to(dev), 8,
              True),
             (_i32(rng, (16, 128)).to(dev), _i32(rng, (16, 128)).to(dev), 16,
              False),
             (_i32(rng, (1, 512)).to(dev), _i32(rng, (40, 64)).to(dev), 7,
              True),
             (_i32(rng, (2, 256)).to(dev), _i32(rng, (2, 5000)).to(dev), 3,
              True)]

    def calls():
        return ([P.probe_transpose(x, K) for x, K in tiles]
                + [P.probe_chain("dep", t, i, K, smem=smem)
                   for t, i, K, smem in deps])

    want = ([P.transpose(x.cpu(), K) for x, K in tiles]
            + [P.dep_gather_loop(t.cpu(), i.cpu(), K) for t, i, K, _ in deps])
    before = P.TRANSPOSE.launches, P.DEP.launches
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = calls()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert (P.TRANSPOSE.launches, P.DEP.launches) == (
        before[0] + 2 * len(tiles), before[1] + 2 * len(deps))
    for o in captured:
        o.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    for a, b, w in zip(got, captured, want, strict=True):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)
    plan = P.transpose_plan(128)
    assert plan["ctas"] == 16
    clk = torch.zeros(1 + plan["ctas"], dtype=torch.int64, device=dev)
    out = P.probe_transpose(tiles[0][0], 4, clk)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), P.transpose(tiles[0][0].cpu(), 4))
    assert int(clk[0]) > 0 and len(set(clk[1:].tolist())) > 1
    with pytest.raises(ValueError, match="clk holds"):
        P.probe_transpose(tiles[0][0], 1, clk[:2])
    with pytest.raises(ValueError, match="n <= 128"):
        P.probe_transpose(_i32(rng, (256, 256)).to(dev), 1)


def test_probe_step5_and_tokens_sync_free_and_graph_replayed(dev):
    """STEP5 (both root sizes, 1, 8 and 32 lanes a CTA, tokens or none, a
    window 4 bytes past a 16-byte boundary, copied first) and TOKENS (alone and through
    the tile: 8 rows over five tiles, 256 rows at 32 and 128 lanes a CTA)
    raise nothing under sync debug mode "error", are captured in a CUDA
    graph and replay equal to plain; STEP5 refuses a shape its kernels are
    not built for, and TOKENS a K that is not a multiple of the tile,
    before launching."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(10)
    steps = []
    for rc, lpc, store in ((128, 1, "none"), (256, 8, "lone"),
                           (256, 32, "lone"), (128, 32, "none")):
        steps.append((store, rc, lpc, _i32(rng, (128, 64)).to(dev),
                      _i32(rng, (rc + 256, 64)).to(dev),
                      _i32(rng, (rc + 256, 64)).to(dev),
                      _i32(rng, (1, 64), 0, 1000).to(dev), 9))
    flat = _i32(rng, (128 * 64 + 1,)).to(dev)
    store, rc, lpc, _, tll, td, bp, K = steps[1]
    steps.append((store, rc, lpc, flat[1:].view(128, 64), tll, td, bp, K))
    t = _i32(rng, (2, 128), 0, 3).to(dev)
    i0 = _i32(rng, (2, 128), 0, 128).to(dev)
    toks = [("lone", 4, 0, 64), ("tile", 4, 8, 40), ("tile", 32, 256, 768),
            ("tile", 128, 256, 768)]

    def calls():
        out = []
        for store, rc, lpc, w, tl, tdd, b, K in steps:
            o, tk = P.probe_step("step5", store, w, tl, tdd, b, K,
                                 lanes_per_cta=lpc, root_cells=rc,
                                 sub_cells=256)
            out += [o] + ([tk] if tk is not None else [])
        for store, lpc, tile, K in toks:
            out += list(P.probe_step("tokens", store, None, t, None, i0, K,
                                     lanes_per_cta=lpc, tile=tile))
        return out

    want = []
    for store, rc, lpc, w, tl, tdd, b, K in steps:
        bp_, tk = P.lane_major_step(w.cpu(), tl.cpu(), tdd.cpu(), b.cpu(), K,
                                    rc, 256)
        want += [bp_] + ([tk] if store != "none" else [])
    for store, lpc, tile, K in toks:
        tk, n = P.tokens_dma(t.cpu(), i0.cpu(), K)
        want += [torch.full((2, 128), n, dtype=torch.int32), tk]
    before = P.STEP.launches
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = calls()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert P.STEP.launches == before + 2 * (len(steps) + len(toks))
    for o in captured:
        o.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    for a, b, w in zip(got, captured, want, strict=True):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)
    launches = P.STEP.launches
    store, rc, lpc, w, tl, tdd, b, K = steps[0]
    for kw in ({"root_cells": 512}, {"sub_cells": 128},
               {"lanes_per_cta": 64}):
        args = {"lanes_per_cta": lpc, "root_cells": rc, "sub_cells": 256,
                **kw}
        with pytest.raises(ValueError, match="step5 runs on the card"):
            P.probe_step("step5", "none", w, tl, tdd, b, K, **args)
    with pytest.raises(ValueError, match="step5 runs on the card"):
        P.probe_step("step5", "none", w[:64], tl, tdd, b, K,
                     lanes_per_cta=lpc, root_cells=rc, sub_cells=256)
    with pytest.raises(ValueError, match="multiple of the tile"):
        P.probe_step("tokens", "tile", None, t, None, i0, 12,
                     lanes_per_cta=4, tile=8)
    assert P.STEP.launches == launches


def test_probe_column_and_step3_sync_free_and_graph_replayed(dev):
    """COLUMN (the TPU probes' three cases, a 1024-row column, 32 index
    rows, the table through __ldg, a table 4 bytes past a 16-byte boundary,
    copied first) and STEP3 (1 to 128 lanes a CTA) raise nothing under sync
    debug mode "error", are captured in a CUDA graph and replay equal to
    plain; COLUMN refuses a shape its kernel does not take (a column of
    2048 or 96 entries, 33 index rows, 48 columns, a post below n - 1 or
    not 2^p - 1) before launching."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(18)
    cols = []
    for n, rows, post, smem in ((8, 8, 0xFFFFFFFF, True),
                                (128, 1, None, True), (512, 8, None, True),
                                (1024, 32, None, True),
                                (128, 1, None, False)):
        cols.append((_i32(rng, (n, 128)).to(dev),
                     _i32(rng, (rows, 128)).to(dev), post, smem))
    flat = _i32(rng, (64 * 128 + 1,)).to(dev)
    cols.append((flat[1:].view(64, 128), cols[1][1], 63, True))
    win, tll, td = (_i32(rng, (4, 128)).to(dev) for _ in range(3))
    bp = _i32(rng, (4, 128), 0, 1 << 16).to(dev)
    lpcs = (1, 2, 4, 8, 16, 32, 64, 128)

    def calls():
        out = [P.probe_column(t, i, 9, smem=smem, post=post)
               for t, i, post, smem in cols]
        return out + [P.probe_step("step3", "none", win, tll, td, bp, 7,
                                   lanes_per_cta=lpc)[0] for lpc in lpcs]

    want = [P._column(t.cpu(), i.cpu(), 9,
                      t.shape[0] - 1 if post is None else post)
            for t, i, post, smem in cols]
    want += [P.step_loop(win.cpu(), tll.cpu(), td.cpu(), bp.cpu(), 7)] * len(
        lpcs)
    before = (P.COLUMN.launches, P.STEP.launches)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = calls()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert (P.COLUMN.launches, P.STEP.launches) == (
        before[0] + 2 * len(cols), before[1] + 2 * len(lpcs))
    for o in captured:
        o.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    for a, b, w in zip(got, captured, want, strict=True):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)
    launches = P.COLUMN.launches
    t, i = cols[1][0], cols[1][1]
    for tt, ii, post in ((_i32(rng, (2048, 128)).to(dev), i, None),
                         (_i32(rng, (96, 128)).to(dev), i, 127),
                         (t, _i32(rng, (33, 128)).to(dev), None),
                         (t[:, :48], i[:, :48], None), (t, i, 63),
                         (t, i, 0x17F)):
        with pytest.raises(ValueError, match="column runs on the card"):
            P.probe_column(tt, ii, 9, post=post)
    assert P.COLUMN.launches == launches


def test_probe_indep_and_bitonic_sync_free_and_graph_replayed(dev):
    """INDEP (W 4 and 8; tables staged 32, 16 and 1 times over, one row or
    a row each, and through __ldg) and BITONIC (the three [8, 128]
    segments, tiles of 64 and 4096 elements, a tile 4 bytes past a 16-byte
    boundary, read a word at a time) raise nothing under sync debug mode
    "error", are captured in a CUDA graph and replay equal to plain; each
    refuses a shape its kernel does not take (a table 96 or 65536 words
    wide staged, a tile of 16 or 8192 elements, or of 3 rows) before
    launching."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(19)
    indeps = [(f"indep{W}", _i32(rng, (t_rows, w)).to(dev),
               _i32(rng, (rows, n)).to(dev), K, smem)
              for W in (4, 8)
              for t_rows, w, rows, n, K, smem in (
                  (128, 128, 128, 128, 4, True), (1, 2048, 8, 300, 3, True),
                  (1, 32768, 2, 64, 5, True), (16, 128, 16, 128, 2, False))]
    flat = _i32(rng, (8 * 128 + 1,)).to(dev)
    sorts = [(_i32(rng, shape).to(dev), segment, K)
             for shape, segment, K in (((8, 128), "flat", 1),
                                       ((8, 128), "rows", 2),
                                       ((8, 128), "cols", 5),
                                       ((3, 8, 8), "rows", 1),
                                       ((64, 64), "flat", 2),
                                       ((2, 2048), "cols", 1))]
    sorts.append((flat[1:].view(8, 128), "flat", 1))

    def calls():
        return ([P.probe_chain(m, t, i, K, smem=smem)
                 for m, t, i, K, smem in indeps]
                + [P.probe_bitonic(x, segment, K) for x, segment, K in sorts])

    want = ([P.indep_gather_loop(t.cpu(), i.cpu(), K, int(m[-1]))
             for m, t, i, K, _ in indeps]
            + [P.bitonic(x.cpu(), segment) for x, segment, _ in sorts])
    before = P.INDEP.launches, P.TILE.launches
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = calls()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert (P.INDEP.launches, P.TILE.launches) == (
        before[0] + 2 * len(indeps), before[1] + 2 * len(sorts))
    for o in captured:
        o.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    for a, b, w in zip(got, captured, want, strict=True):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)
    launches = P.INDEP.launches, P.TILE.launches
    i = indeps[0][2]
    for w in (96, 65536):
        with pytest.raises(ValueError, match="indep runs on the card"):
            P.probe_chain("indep8", _i32(rng, (1, w)).to(dev), i, 2)
    for shape in ((4, 4), (64, 128), (3, 32)):
        with pytest.raises(ValueError, match="bitonic runs on the card"):
            P.probe_bitonic(_i32(rng, shape).to(dev), "flat")
    assert (P.INDEP.launches, P.TILE.launches) == launches


def test_probe_bitonic_row_sync_free_and_graph_replayed(dev):
    """The 64K sorts (qz_probe_bitonic_row) at [1, 65536] and [32, 65536],
    on full-range int32 keys with negatives and repeats: as rows and as
    [B, 512, 128] tiles, from a row 4 bytes past a 16-byte boundary, and
    sorted 3 and 2 times, each equal to the plain network and to np.sort
    in signed order; no call synchronises under sync debug mode "error",
    each is captured in a CUDA graph and replays equal, one launch a call;
    clk gets the sort's ticks and the 16 SMs of the row's cluster; a shape
    the kernel does not take, or a clk too short, raises ValueError before
    launching."""
    from qatzip_tpu_torch.tools import probes as P

    rng = np.random.default_rng(20)
    rows = []
    for B in (1, 32):
        x = _i32(rng, (B, 65536))
        x[:, 1::7] = x[:, ::7][:, :x[:, 1::7].shape[1]]
        x[:, 2::5] = _i32(rng, x[:, 2::5].shape, -3, 3)
        rows.append(x)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32), rows[0].reshape(-1)])
    cases = [(rows[0].to(dev), 1), (rows[1].to(dev), 1),
             (rows[1].to(dev).view(32, 512, 128), 1),
             (flat.to(dev)[1:].view(1, 65536), 1),
             (rows[0].to(dev), 3), (rows[1].to(dev), 2)]
    want = []
    for x, _ in cases:
        w = np.sort(x.cpu().reshape(x.shape[0], -1).numpy(), axis=1)
        plain = P.probe_bitonic_64k(x.cpu())
        assert np.array_equal(plain.reshape(w.shape).numpy(), w)
        want.append(plain)

    def calls():
        return [P.probe_bitonic_64k(x, K) for x, K in cases]

    before = P.ROW.launches
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = calls()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = calls()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert P.ROW.launches == before + 2 * len(cases)
    for o in captured:
        o.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    for a, b, w in zip(got, captured, want, strict=True):
        assert torch.equal(a.cpu(), w) and torch.equal(b.cpu(), w)
    clk = torch.zeros(17, dtype=torch.int64, device=dev)
    P.probe_bitonic_64k(cases[0][0], clk=clk)
    torch.cuda.synchronize()
    assert int(clk[0]) > 0 and len(set(clk[1:].tolist())) == 16
    launches = P.ROW.launches
    x = cases[1][0]
    for bad in (x[:, :4096], x.view(32, 128, 512), x.view(-1), x[None]):
        with pytest.raises(ValueError, match="64K sort takes"):
            P.probe_bitonic_64k(bad)
    with pytest.raises(ValueError, match="clk holds"):
        P.probe_bitonic_64k(x, clk=clk[:16])
    assert P.ROW.launches == launches


def test_probe_roll_rows_keeps_no_shared_memory(dev):
    """The row roll's kernel is a copy from global to global: its code
    holds no shared-memory access and no barrier."""
    import subprocess

    from qatzip_tpu_torch.ops import _build

    lib = _build.build(name=_build.PROBES)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if f.startswith("_Z13qzp_roll_rows")]
    assert len(funcs) == 2   # 16-byte vectors, and words
    for f in funcs:
        ops = f.split("\n", 1)[1]
        for op in ("LDS", "STS", "BAR"):
            assert op not in ops, f.split("\n", 1)[0]


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
    # the card's pass went through the chain-walk kernel (and, for
    # deflate, the checksum kernel): one launch each for the batch
    assert _parity_launches(lambda: codec.compress_chunks(
        chunks, params, dev)) == {"chain_walk": 1,
                                  "checksums": int(algo == "deflate")}
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
    # the card's rounds went through the chain-walk and checksum kernels
    rounds = _spec_rounds(monkeypatch)
    n = _parity_launches(lambda: dd.inflate_batch(payloads, hints, dev,
                                                  kind="crc32"))
    assert rounds and n == {"chain_walk": len(rounds),
                            "checksums": len(rounds)}


def _parity_launches(fn) -> dict:
    """The chain-walk and checksum kernels' launches while fn runs."""
    from qatzip_tpu_torch.ops import chain as CH
    from qatzip_tpu_torch.ops import checksums as ck

    n0 = CH.KERNEL.launches, ck.KERNEL.launches
    fn()
    torch.cuda.synchronize()
    return {"chain_walk": CH.KERNEL.launches - n0[0],
            "checksums": ck.KERNEL.launches - n0[1]}


def _spec_rounds(monkeypatch) -> list:
    """A list that gets an entry for each speculative round from now on."""
    from qatzip_tpu_torch.ops import deflate_decode as dd

    rounds = []
    real = dd._run_device_round_spec

    def counted(batch, device):
        rounds.append(len(batch))
        return real(batch, device)

    monkeypatch.setattr(dd, "_run_device_round_spec", counted)
    return rounds


def _captured_maps(fn) -> list:
    """The (map, seg) pairs fn hands to chain.chain_walk."""
    from qatzip_tpu_torch.ops import chain as CH

    maps = []
    real = CH.chain_walk

    def record(f, seg):
        maps.append((f.clone(), seg))
        return real(f, seg)

    CH.chain_walk = record
    try:
        fn()
    finally:
        CH.chain_walk = real
    return maps


def _engine_map(dev, which: str):
    """A map the engine builds on the card at its real shape: the device
    encoder's batch of 128 chunks of 64 KB ([128, 65536], seg 256), or a
    speculative round of 8 zlib-L1 streams of 64 KB ([8, 2^19], seg
    512)."""
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import deflate_encode as de

    n = 65536
    if which == "encoder":
        blob = np.frombuffer(_text(128 * n, 31), np.uint8).reshape(128, n)
        data = torch.zeros((128, n + 8), dtype=torch.uint8, device=dev)
        data[:, :n] = torch.from_numpy(blob.copy()).to(dev)
        lens = torch.full((128,), n, dtype=torch.int32, device=dev)
        maps = _captured_maps(lambda: de.analyze_blocks(data, lens, 8, 16))
    else:
        payloads = []
        for s in range(8):
            co = zlib.compressobj(1, zlib.DEFLATED, -15)
            payloads.append(co.compress(_text(n, 40 + s)) + co.flush())
        os.environ["QATZIP_TPU_INFLATE"] = "spec"
        try:
            maps = _captured_maps(lambda: dd.inflate_batch(
                payloads, [n] * 8, dev, kind="crc32"))
        finally:
            os.environ.pop("QATZIP_TPU_INFLATE", None)
    return maps[0]


@pytest.mark.parametrize("case", ["encoder", "decoder", "steps of 1",
                                  "all n", "random", "partial warp"])
def test_chain_kernel_equals_plain(dev, case):
    """The chain-walk kernel against chain_walk_ref on the same map on the
    card: the engines' own maps at their shapes, steps of 1 and jumps to n
    at both, random steps, and 5 rows of 20 segments (a warp partly
    idle)."""
    from qatzip_tpu_torch.ops import chain as CH

    shapes = {"steps of 1": (8, 1 << 19, 512), "all n": (128, 65536, 256),
              "random": (128, 65536, 256), "partial warp": (5, 5120, 256)}
    if case in ("encoder", "decoder"):
        f, seg = _engine_map(dev, case)
    else:
        B, n, seg = shapes[case]
        pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        if case == "steps of 1":
            f = (pos + 1).expand(B, n).contiguous()
        elif case == "all n":
            f = torch.full((B, n), n, dtype=torch.int32, device=dev)
        else:
            g = torch.Generator(device=dev).manual_seed(7)
            step = torch.randint(1, 300, (B, n), generator=g, device=dev,
                                 dtype=torch.int32)
            f = torch.clamp(pos + step, max=n)
    n0 = CH.KERNEL.launches
    got = CH.chain_walk(f, seg)
    assert CH.KERNEL.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, CH.chain_walk_ref(f, seg))


def test_checksum_kernel_equals_plain(dev):
    """The checksum kernel against the plain versions and zlib on the
    card: a ragged [128, 65536] batch in rows 8 bytes wider than n (the
    encoder's staging), the length sweep at n 1024, rows of 0xFF at full
    length, and rows 1027 bytes apart (not 8-byte aligned, read a byte a
    load); one launch a call."""
    from qatzip_tpu_torch.ops import checksums as ck

    rng = np.random.default_rng(5)
    n = 65536
    lens = [0, 1, 3, 4, 255, 256, 257, 1023, 1024, 1025, n - 1, n] + list(
        rng.integers(0, n + 1, 116))
    cases = [(rng.integers(0, 256, (128, n + 8), dtype=np.uint8), lens, n),
             (rng.integers(0, 256, (80, 1024), dtype=np.uint8),
              list(range(65)) + [127, 128, 129, 255, 256, 257, 511, 512, 513,
                                 777, 1000, 1022, 1023, 1024, 3], 1024),
             (np.full((4, n), 0xFF, np.uint8), [n, n - 1, n // 2, 7], n),
             (rng.integers(0, 256, (41, 1027), dtype=np.uint8),
              list(range(0, 1025, 27)) + [1024, 1023, 1], 1024)]
    for host, ln, n in cases:
        data = torch.from_numpy(host).to(dev)
        lt = torch.tensor(ln, dtype=torch.int32, device=dev)
        for kind in ("crc32", "adler32"):
            fn = getattr(ck, f"{kind}_blocks")
            n0 = ck.KERNEL.launches
            got = fn(data, lt, n)
            assert ck.KERNEL.launches == n0 + 1
            torch.cuda.synchronize()
            assert torch.equal(got, getattr(ck, f"{kind}_blocks_ref")(
                data, lt, n))
            assert got.cpu().tolist() == [
                getattr(zlib, kind)(host[i, :k].tobytes())
                for i, k in enumerate(ln)]


@pytest.mark.parametrize("B,n,seg,path", [
    (128, 65536, 256, "cluster"), (8, 1 << 18, 512, "cluster"),
    (8, 1 << 19, 512, "cluster"), (8, 1 << 20, 512, "rows"),
    (1, 1 << 22, 32, "rows")])
@pytest.mark.parametrize("kind", ["steps of 1", "random"])
def test_chain_kernel_paths_at_the_cut(dev, B, n, seg, path, kind):
    """Both paths at the cut between them and on either side of it: the
    encoder's shape, 2^18 and 2^19 (a cluster of 16 CTAs) take one cluster
    launch, 2^20 and the [1, 2^22] probe the three-launch row path; each
    equal to chain_walk_ref, one counted call, and the card holds the
    cluster."""
    from qatzip_tpu_torch.ops import chain as CH

    assert CH.check_kernel_limits(n, seg) == path
    info = CH.launch_info(n, seg)
    assert (info["c"] > 0) == (path == "cluster")
    if path == "cluster":
        assert info["active_clusters"] > 0
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    if kind == "steps of 1":
        f = (pos + 1).expand(B, n).contiguous()
    else:
        g = torch.Generator(device=dev).manual_seed(B + n)
        f = torch.clamp(pos + torch.randint(1, 2 * seg, (B, n), generator=g,
                                            device=dev, dtype=torch.int32),
                        max=n)
    n0 = CH.KERNEL.launches
    got = CH.chain_walk(f, seg)
    assert CH.KERNEL.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, CH.chain_walk_ref(f, seg))


def test_chain_kernel_refusals_raise(dev):
    """A launch the entry refuses raises KernelError, never a plain run: a
    cluster launch of no rows, a map not 16-byte aligned handed straight
    to the cluster entry, and the row path without its scratch."""
    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.ops import chain as CH

    f = torch.ones((1, 65536 + 4), dtype=torch.int32, device=dev)
    out = torch.empty((1, 65536), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with pytest.raises(_build.KernelError, match="invalid argument"):
        CH.KERNEL(f.data_ptr(), out.data_ptr(), None, 0, 65536, 256,
                  CH.ALL_PHASES, stream)
    with pytest.raises(_build.KernelError, match="misaligned"):
        CH.KERNEL(f.data_ptr() + 4, out.data_ptr(), None, 1, 65536, 256,
                  CH.ALL_PHASES, stream)
    big = torch.ones((1, 1 << 20), dtype=torch.int32, device=dev)
    with pytest.raises(_build.KernelError):
        CH.KERNEL(big.data_ptr(), big.data_ptr(), None, 1, 1 << 20, 512,
                  CH.ALL_PHASES, stream)


def test_chain_probe_loads(dev):
    """The dependent shared-memory load probe runs, and a load from the
    cluster sibling's shared memory takes longer than one from the CTA's
    own."""
    from qatzip_tpu_torch.ops import chain as CH

    local = CH.probe_clocks(False, 4096, dev) / 4096
    remote = CH.probe_clocks(True, 4096, dev) / 4096
    assert 10 < local < remote < 2000


@pytest.mark.parametrize("rows", [1, 8, 128])
def test_checksum_kernel_rows_at_odd_stride(dev, rows):
    """The checksums at 1, 8 and 128 rows (8, 8 and 1 CTAs a row) on rows
    65539 bytes apart (not 8-byte aligned) and on aligned rows, with
    int32 and int64 lengths: one launch a call, equal to the plain
    versions and to zlib."""
    from qatzip_tpu_torch.ops import checksums as ck

    rng = np.random.default_rng(rows)
    n = 65536
    lens = ([0, 1, 7, 8, n - 1, n] + list(rng.integers(0, n + 1, rows)))[
        :rows]
    for width in (n + 3, n):
        host = rng.integers(0, 256, (rows, width), dtype=np.uint8)
        data = torch.from_numpy(host).to(dev)
        for dtype in (torch.int32, torch.int64):
            lt = torch.tensor(lens, dtype=dtype, device=dev)
            for kind in ("crc32", "adler32"):
                n0 = ck.KERNEL.launches
                got = getattr(ck, f"{kind}_blocks")(data, lt, n)
                assert ck.KERNEL.launches == n0 + 1
                torch.cuda.synchronize()
                assert torch.equal(got, getattr(ck, f"{kind}_blocks_ref")(
                    data, lt, n))
                assert got.cpu().tolist() == [
                    getattr(zlib, kind)(host[i, :k].tobytes())
                    for i, k in enumerate(lens)]


def test_parity_engines_never_run_the_plain_versions_on_cuda(dev,
                                                             monkeypatch):
    """With the chain walk's and the checksums' plain versions made to
    raise, the device encoder and the speculative decoder still run on
    the card: a CUDA tensor never reaches a plain version."""
    from qatzip_tpu_torch.ops import chain as CH
    from qatzip_tpu_torch.ops import checksums as ck
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import device_codecs as dc

    def refuse(*a, **k):
        raise AssertionError("a plain version ran")

    for mod, name in ((CH, "chain_walk_ref"), (ck, "crc32_blocks_ref"),
                      (ck, "adler32_blocks_ref")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setenv("QATZIP_TPU_ENCODER", "device")
    monkeypatch.setenv("QATZIP_TPU_INFLATE", "spec")
    data = _text(4 * 16384, 13)
    chunks = [data[i:i + 16384] for i in range(0, len(data), 16384)]
    out = dc.DeflateDeviceCodec().compress_chunks(chunks, _internal(
        "deflate"), dev)
    assert [r.checksum for r in out] == [zlib.crc32(c) for c in chunks]
    payloads = [r.payload for r in out]
    for kind in ("crc32", "adler32"):
        got = dd.inflate_batch(payloads, [16384] * 4, dev, kind=kind)
        assert [g[0] for g in got] == chunks
        assert [g[2] for g in got] == [getattr(zlib, kind)(c)
                                       for c in chunks]


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
    edges = [b for _, b in LC.ring_edge_blocks()]
    sets += [("ring edges", edges, False), ("ring edges", edges, True)]
    # one request-wide launch: more rows than the plain version's GROUP
    sets.append(("request", [lz4_block_compress(_text(4096, s))
                             for s in range(261)], False))
    return sets


def _lz4_group(blocks, dev):
    from qatzip_tpu_torch.ops import lz4_decode as ld

    n = ld._next_pow2(max(len(b) for b in blocks) + 8, 1024)
    arr = np.zeros((len(blocks), n), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    return torch.from_numpy(arr).to(dev), lens.to(dev), n


@pytest.mark.parametrize("case", range(10))
def test_lz4_kernel_equals_plain(dev, case):
    """The kernel against the plain version on the same tensors on the
    card: every row's err, and tot and bytes where it is clear; a clear
    row's bytes are the host decoder's.  The cases include the kernel's
    shared-memory edges and one launch of 261 rows."""
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
    if name in ("corpus", "lz4s above 64 KB", "request") or (
            name == "ring edges" and not lz4s):
        assert not bool(got[2].any())
    elif name == "fuzz":
        assert 0 < int(got[2].sum()) < len(blocks)


@pytest.mark.parametrize("cap_rows", [None, 64])
def test_lz4_decode_blocks_launches_once_a_group(dev, monkeypatch,
                                                 cap_rows):
    """decode_blocks on cuda:0 launches the kernel once a capped launch
    (LAUNCH_OUT_BYTES of output rows: 133 blocks, more than the plain
    version's GROUP, in one launch; with the cap at 64 rows, three) and
    never runs the plain version."""
    from qatzip_tpu_torch.engine.lz4_block import lz4_block_compress
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import lz4_kernel as LK

    plain = []
    impl = ld._decode_blocks_impl
    monkeypatch.setattr(ld, "_decode_blocks_impl",
                        lambda *a: plain.append(1) or impl(*a))
    if cap_rows:
        monkeypatch.setattr(ld, "LAUNCH_OUT_BYTES", cap_rows * ld.MAX_OUT)
    datas = [_text(4096, s) for s in range(ld.GROUP + 5)]
    blocks = [lz4_block_compress(d) for d in datas]
    launches = LK.KERNEL.launches
    assert ld.decode_blocks(blocks, device=dev) == datas
    assert LK.KERNEL.launches - launches == (-(-len(blocks) // cap_rows)
                                             if cap_rows else 1)
    assert not plain


def test_lz4_kernel_launch_shape(dev):
    """The kernel's CTA (two warps), its shared memory and the CTAs the
    card holds at once: the design's 3 a SM."""
    from qatzip_tpu_torch.ops import lz4_kernel as LK

    info = LK.launch_info()
    assert info["threads"] == 64
    assert 65536 + 4096 <= info["smem_bytes"] <= 75 * 1024
    assert info["ctas_per_sm"] == 3 and info["sms"] > 0


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


def test_inflate_kernel_records_lie_in_their_device_spans(dev, monkeypatch):
    """Under a profiler, each inflate kernel's device record lies inside a
    ``qz.inflate.device`` range of the thread whose
    ``qz.launch.qz_inflate_decode`` range launched it: two clients
    decompress at once, each request traced by the profiler alone."""
    import threading

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.ops import inflate_kernel as K
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    _engine_on(dev)
    datas = [_text(300_000, 30 + i) for i in range(2)]
    comps = [qt.compress(d, level=1, hw_buff_sz=16384) for d in datas]
    assert qt.decompress(comps[0], hw_buff_sz=16384) == datas[0]   # warm
    outs = {}

    def client(i):
        outs[i] = qt.decompress(comps[i], hw_buff_sz=16384)

    try:
        from torch._C._profiler import _ExperimentalConfig

        kw = {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        kw = {}
    before = K.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kw) as prof:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert [outs[i] for i in range(2)] == datas
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    kernels = [e for e in events if e.device_type() == cuda
               and "qz_inflate" in e.name()
               and not e.name().startswith("qz.")]     # annotations
    assert len(kernels) == K.KERNEL.launches - before >= 2

    def ranges(name):
        out: dict = {}
        for e in host:
            if e.name() == name:
                out.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns()))
        return out

    device = ranges("qz.inflate.device")
    assert len(device) == 2
    # the clients launch on one stream, which runs the kernels in the order
    # of their launches: the i-th record is the i-th launch's
    launches = sorted((a, b, tid) for tid, rs in ranges(
        "qz.launch.qz_inflate_decode").items() for a, b in rs)
    kernels.sort(key=lambda k: k.start_ns())
    assert len(launches) == len(kernels)
    for k, (a, _, tid) in zip(kernels, launches):
        s, e = k.start_ns(), k.start_ns() + k.duration_ns()
        assert a <= s
        assert any(da <= s and e <= db for da, db in device[tid]), k.name()
