"""The construct probes' port against the TPU probes, on the CPU.

``qatzip_tpu_torch/tools/probes.py`` holds a plain torch version of every
``pl.pallas_call`` kernel of ``tools/probe_pallas*.py`` and
``tools/probe_inflate_step*.py`` and the wrappers of their Hopper kernels,
which on CPU tensors run the plain versions.  Where the TPU function can be
imported (defined at module level), it runs here in Pallas interpret mode
on the same numpy inputs, made from a seed at a small size, and must equal
the port exactly: all are integers.  Where the kernel is local to a
``main()``, the port is held against the check that main prints (np.roll,
np.sort, ``tbl.flat[idx]``) or a numpy transcription of its body.  The
probe files are loaded by path and left unedited; ``os.environ`` is
restored after each import (they set ``JAX_COMPILATION_CACHE_DIR``).
"""
import functools
import importlib.util
import os
import pathlib

import jax.experimental.pallas as pallas
import numpy as np
import pytest
import torch

from qatzip_tpu_torch.tools import probe_bench as PB
from qatzip_tpu_torch.tools import probes as P

ROOT = pathlib.Path(__file__).resolve().parent.parent
_PALLAS_CALL = pallas.pallas_call


def _load(name: str):
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_tpu_{name}", ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


@pytest.fixture(scope="module")
def tpu():
    names = ("probe_inflate_step", "probe_inflate_step3",
             "probe_inflate_step4", "probe_inflate_step5", "probe_pallas3")
    return {n.replace("probe_", ""): _load(n) for n in names}


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the TPU probes runs in interpret mode."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(_PALLAS_CALL, interpret=True))


def _t(a: np.ndarray) -> torch.Tensor:
    """int32 (or uint32 bits as int32) numpy -> torch."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (got.numpy() == want.view(np.int32)).all()


def _rng(seed: int):
    return np.random.default_rng(seed)


def _i32(rng, shape, lo=-2**31, hi=2**31):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


# -- "interp" rows: the TPU function in interpret mode -----------------------


@pytest.mark.parametrize("K", [1, 5])
def test_dep_gather_loop(tpu, interpret, K):
    rng = _rng(K)
    t, i0 = _i32(rng, (8, 128)), _i32(rng, (8, 128))
    want = tpu["inflate_step"].dep_gather_loop(8, K)(t, i0)
    _eq(P.dep_gather_loop(_t(t), _t(i0), K), want)
    _eq(P.probe_chain("dep", _t(t), _t(i0), K), want)


def test_dep_loop(tpu, interpret, monkeypatch):
    m = tpu["inflate_step3"]
    monkeypatch.setattr(m, "R", 8)
    rng = _rng(2)
    t, i0 = _i32(rng, (8, 128)), _i32(rng, (8, 128))
    _eq(P.dep_gather_loop(_t(t), _t(i0), 7), m.dep_loop(7)(t, i0))


@pytest.mark.parametrize("W", [4, 8])
def test_indep_gather_loop(tpu, interpret, W):
    rng = _rng(W)
    t, i0 = _i32(rng, (8, 128)), _i32(rng, (8, 128))
    want = tpu["inflate_step"].indep_gather_loop(8, 3, W)(t, i0)
    _eq(P.indep_gather_loop(_t(t), _t(i0), 3, W), want)
    _eq(P.probe_chain(f"indep{W}", _t(t), _t(i0), 3), want)


def test_elemwise_loop_against_numpy_with_32_bit_wrap(tpu):
    """The JAX function does not trace under this jax (2654435761 does not
    fit in int32); its body in numpy uint32, which wraps as int32 does."""
    rng = _rng(3)
    t, i0 = _i32(rng, (8, 128)), _i32(rng, (8, 128))
    with pytest.raises(OverflowError):
        tpu["inflate_step"].elemwise_loop(8, 4)(t, i0)
    x = i0.view(np.uint32).copy()
    for _ in range(4):
        v = (x * np.uint32(2654435761) + np.uint32(12345)) & np.uint32(
            0x7FFFFFFF)
        x = (v ^ (v >> np.uint32(7))) & np.uint32(0xFFFF)
    _eq(P.elemwise_loop(_t(i0), 4), x)
    _eq(P.probe_alu("hash", _t(i0), 4), x)


def test_refill_dma(tpu, interpret):
    rng = _rng(4)
    B, NW, WIN = 8, 256, 128
    stream = _i32(rng, (B, NW))
    off = rng.integers(0, NW - WIN, (1, B)).astype(np.int32)
    want = tpu["inflate_step"].refill_dma(B, NW, WIN)(off, stream)
    _eq(P.refill_dma(_t(off), _t(stream), WIN), want)
    for how in ("ld", "cp", "tma"):   # offsets a CPU tensor or an array
        _eq(P.probe_refill(_t(stream), _t(off), WIN, how=how), want)
        _eq(P.probe_refill(_t(stream), off[0], WIN, how=how), want)


def test_refill_vmem(tpu, interpret, monkeypatch):
    m = tpu["inflate_step3"]
    monkeypatch.setattr(m, "R", 8)
    rng = _rng(5)
    stream = _i32(rng, (8, 512))
    off = rng.integers(0, 512 - 64, (8,)).astype(np.int32)
    want = m.refill_vmem(512, 64)(off, stream)
    _eq(P.refill_vmem(_t(off), _t(stream), 64), want)
    for how in ("ld", "cp", "tma"):
        _eq(P.probe_refill(_t(stream), off, 64, how=how), want)


@pytest.mark.parametrize("nrefills", [1, 2, 3])
def test_refill3d(tpu, interpret, monkeypatch, nrefills):
    m = tpu["inflate_step4"]
    monkeypatch.setattr(m, "R", 8)
    rng = _rng(nrefills)
    stream = _i32(rng, (8, 16, 64))
    blkv = rng.integers(0, 14, (1, 8)).astype(np.int32)
    want = m.refill3d(16, nrefills)(stream, blkv)
    _eq(P.refill3d(_t(stream), _t(blkv), nrefills), want)
    flat = _t(stream).reshape(8, 16 * 64)
    for how in ("ld", "cp", "tma"):
        got = P.probe_refill(flat, _t(blkv) * 64, 128, nrefills, alt=64,
                             how=how)
        _eq(got.reshape(8, 2, 64), want)


# a window before the stream, past its end, an odd refill moved past the
# end by alt, and one moved before the start by a negative alt
@pytest.mark.parametrize("first,last,K,alt", [
    (-1, 0, 1, 0), (0, 256 - 127, 1, 0), (0, 256 - 128 - 60, 2, 64),
    (3, 100, 3, -4)])
def test_refill_window_outside_the_stream_is_refused(first, last, K, alt):
    """The bounds come from the host offsets, before any launch: a
    ValueError, no launch counted."""
    stream = _t(_i32(_rng(14), (4, 256)))
    off = np.array([first, 5, 9, last], np.int32)
    before = P.REFILL.launches
    for how in ("ld", "cp", "tma"):
        with pytest.raises(ValueError, match="outside its stream"):
            P.probe_refill(stream, off, 128, K, alt=alt, how=how)
    assert P.REFILL.launches == before
    ok = np.clip(off, 4, 256 - 128 - 64)   # the same call, inside
    _eq(P.probe_refill(stream, ok, 128, K, alt=alt),
        P._refill(stream, _t(ok), 128, K, alt))


def test_step_loop(tpu, interpret, monkeypatch):
    """The decode-step skeleton on tables and windows over the whole int32
    range (arithmetic shifts of negative words, wrapped sums)."""
    m = tpu["inflate_step3"]
    monkeypatch.setattr(m, "R", 8)
    rng = _rng(6)
    win, tll, td = (_i32(rng, (8, 128)) for _ in range(3))
    i0 = _i32(rng, (8, 128), 0, 1 << 12)
    want = m.step_loop(6)(win, tll, td, i0)
    _eq(P.step_loop(*map(_t, (win, tll, td, i0)), 6), want)
    out, toks = P.probe_step("step3", "none", *map(_t, (win, tll, td, i0)), 6)
    _eq(out, want)
    assert toks is None


def test_tokens_dma(tpu, interpret, monkeypatch):
    """Row 0's tokens (the TPU kernel's tile) and the step count."""
    m = tpu["inflate_step4"]
    monkeypatch.setattr(m, "R", 8)
    rng = _rng(7)
    t = rng.integers(0, 3, (8, 128)).astype(np.int32)
    i0 = rng.integers(0, 128, (8, 128)).astype(np.int32)
    out, done = m.tokens_dma(8, 4, 8)(t, i0)
    toks, steps = P.tokens_dma(_t(t)[:1], _t(i0)[:1], 8)
    _eq(toks, out)
    assert steps == int(np.asarray(done)[0, 0]) == 8
    for store in ("lone", "tile"):
        n, toks = P.probe_step("tokens", store, None, _t(t)[:1], None,
                               _t(i0)[:1], 8, tile=4)
        _eq(toks, out)
        assert (n == 8).all()


@pytest.mark.parametrize("rows", [1, 8, 128])
def test_ew(tpu, interpret, rows):
    rng = _rng(rows)
    x = rng.integers(0, 1 << 32, (rows, 128), dtype=np.int64).astype(
        np.uint32)
    want = tpu["inflate_step5"].mk_ew((rows, 128))(3)(x)
    _eq(P.ew(_t(x), 3), want)
    _eq(P.probe_alu("ew", _t(x), 3), want)


def test_subshuf(tpu, interpret):
    rng = _rng(8)
    t8, i8 = (rng.integers(0, 8, (8, 128)).astype(np.int32)
              for _ in range(2))
    want = tpu["inflate_step5"].mk_subshuf(0)(4)(t8, i8)
    _eq(P.subshuf(_t(t8), _t(i8), 4), want)
    _eq(P.probe_chain("column", _t(t8), _t(i8), 4, post=0xFFFFFFFF), want)


@pytest.mark.parametrize("N", [64, 128])
def test_onehot(tpu, interpret, N):
    rng = _rng(N)
    t = rng.integers(0, N, (N, 128)).astype(np.int32)
    i1 = rng.integers(0, N, (1, 128)).astype(np.int32)
    want = tpu["inflate_step5"].mk_onehot(N)(3)(t, i1)
    _eq(P.onehot(_t(t), _t(i1), 3), want)
    _eq(P.probe_chain("column", _t(t), _t(i1), 3), want)


def test_groupsel(tpu, interpret):
    rng = _rng(9)
    N = 64
    t = rng.integers(0, N, (N, 128)).astype(np.int32)
    ig = np.repeat(rng.integers(0, N, (1, 128)).astype(np.int32), 8, axis=0)
    want = tpu["inflate_step5"].mk_groupsel(N)(2)(t, ig)
    _eq(P.groupsel(_t(t), _t(ig), 2), want)
    _eq(P.probe_chain("column", _t(t), _t(ig), 2), want)


# the TPU probes' three COLUMN cases (B, C at N 64 and 128, C2 at 512) and
# the card tests' other heights, through COLUMN's own wrapper
@pytest.mark.parametrize("N,R,post", [(8, 8, 0xFFFFFFFF), (64, 1, None),
                                      (128, 1, None), (512, 8, None),
                                      (1024, 4, 0xFFFFFFFF), (16, 3, 31)])
def test_probe_column_equals_plain(tpu, interpret, N, R, post):
    """probe_column (the COLUMN kernel's wrapper) on CPU tensors equals the
    TPU probe's function where it has one (mk_subshuf at N 8, mk_onehot
    at one index row, post N - 1) and _column for every shape, as does
    probe_chain's column mode, which is that wrapper."""
    rng = _rng(N + R)
    t = rng.integers(0, N, (N, 128)).astype(np.int32)
    idx = rng.integers(0, N, (R, 128)).astype(np.int32)
    want = P._column(_t(t), _t(idx), 5, N - 1 if post is None else post)
    if N == 8:
        _eq(want, tpu["inflate_step5"].mk_subshuf(0)(5)(t, idx))
    if R == 1 and post is None:
        _eq(want, tpu["inflate_step5"].mk_onehot(N)(5)(t, idx))
    for smem in (True, False):
        assert torch.equal(P.probe_column(_t(t), _t(idx), 5, smem=smem,
                                          post=post), want)
    assert torch.equal(P.probe_chain("column", _t(t), _t(idx), 5, post=post),
                       want)


def test_column_shapes_the_card_takes():
    """COLUMN's kernel takes a column of n a power of 2 up to 1024 entries,
    a multiple of 32 columns, 1-32 index rows and a post 2^p - 1 of at
    least n - 1 (the mask it applies once, after the last step); any other
    shape is refused by name."""
    for n, rows, cols, post in ((8, 8, 128, 0xFFFFFFFF), (128, 1, 128, 127),
                                (512, 8, 128, 511), (1024, 32, 32, 1023),
                                (1, 1, 64, 0), (64, 1, 128, -1)):
        P.column_check(n, rows, cols, post)
    for bad in ((2048, 1, 128, 2047), (96, 1, 128, 127), (128, 33, 128, 127),
                (128, 0, 128, 127), (128, 1, 48, 127), (128, 1, 16, 127),
                (128, 1, 128, 63), (128, 1, 128, 0x17F), (0, 1, 128, 0)):
        with pytest.raises(ValueError, match="column runs on the card"):
            P.column_check(*bad)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_transpose(tpu, interpret, K):
    """The TPU probe's [128, 128] tile in interpret mode; the port's other
    tile sizes (a cluster of 4 CTAs, one CTA, a block smaller than 32)
    against a numpy transcription of its body."""
    rng = _rng(K)
    x = _i32(rng, (128, 128))
    want = tpu["inflate_step5"].mk_transpose()(K)(x)
    _eq(P.transpose(_t(x), K), want)
    _eq(P.probe_transpose(_t(x), K), want)
    for n in (8, 32, 64):
        y = _i32(rng, (n, n))
        want = y.astype(np.int64)
        for _ in range(K):
            want = want.T + 1
        want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
        _eq(P.transpose(_t(y), K), want)
        _eq(P.probe_transpose(_t(y), K), want)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128])
def test_transpose_plan(n):
    """The cluster that probe_transpose launches: 32 x 32 blocks, one a
    CTA, (n / 32)^2 CTAs (16 at the TPU probe's n = 128, each of 256
    threads moving 16 bytes at once), a single CTA up to n = 32."""
    p = P.transpose_plan(n)
    assert p["b"] == min(n, 32) and p["nb"] * p["b"] == n
    assert p["ctas"] == max(1, (n // 32) ** 2)
    if n == 128:
        assert (p["ctas"], p["threads"], p["stride"]) == (16, 256, 36)
    assert p["threads"] * 4 >= p["b"] ** 2 and p["stride"] % 4 == 0


@pytest.mark.parametrize("root_cells", [128, 256])
def test_lane_major_step(tpu, interpret, root_cells):
    """The lane-major skeleton ("onehot" fetches) on random cells, so that
    every kind, subtable pointers past the subtable area and every
    distance symbol occur; bitpos only, as the TPU function returns."""
    rng = _rng(root_cells)
    W, sc, K = 128, 256, 2

    def u32(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.int64).astype(
            np.uint32)

    win, tll, td = u32((W, 128)), u32((root_cells + sc, 128)), u32(
        (root_cells + sc, 128))
    bp = rng.integers(0, 1000, (1, 128)).astype(np.int32)
    make, r0 = tpu["inflate_step5"].mk_lane_major_step(W, root_cells, sc,
                                                       "onehot")
    want = make(K)(win, tll, td, bp)
    got, toks = P.lane_major_step(*map(_t, (win, tll, td, bp)), K,
                                  root_cells, sc)
    _eq(got, want)
    assert toks.shape == (K, 128)
    out, toks2 = P.probe_step("step5", "lone", *map(_t, (win, tll, td, bp)),
                              K, root_cells=root_cells, sub_cells=sc)
    _eq(out, want)
    assert torch.equal(toks2, toks)


@pytest.mark.parametrize("S,shift,axis", [
    (16, 1, 0), (16, 4, 0), (512, 1, 0), (512, 64, 0), (512, 256, 0),
    (512, 448, 0), (8, 32, 1), (8, 96, 1), (8, 127, 1)])
def test_pallas_roll(tpu, interpret, S, shift, axis):
    """The nine cases of probe_pallas3.py's main."""
    x = _i32(_rng(S + shift), (S, 128), 0, 1 << 30)
    want = tpu["pallas3"].pallas_roll(x, shift, axis)
    _eq(P.roll(_t(x), shift, axis), want)
    _eq(P.probe_roll(_t(x), shift, axis), want)


# -- "oracle" rows: kernels local to a main() --------------------------------


def test_p_double_and_p_roll():
    """probe_pallas.py:53 and :68 on the probe's arange input."""
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    _eq(P.double(_t(x)), x * 2)
    _eq(P.probe_alu("double", _t(x), 1), x * 2)
    _eq(P.roll(_t(x), 1, 1), np.roll(x, 1, axis=1))


@pytest.mark.parametrize("n,K", [(128, 1), (128, 8), (1001, 3)])
def test_shfl_and_bar_units(n, K):
    """The units of BITONIC's latency figure (no TPU kernel): K dependent
    shuffles with the neighbour lane swap each pair (an odd last element
    pairs with the padding lane's 0) K % 2 times; K barriers each followed
    by + 1 add K, with 32-bit wrap."""
    x = _i32(_rng(n + K), (n,))
    pairs = np.concatenate([x, np.zeros(n % 2, np.int32)]).reshape(-1, 2)
    want = (pairs[:, ::-1] if K % 2 else pairs).reshape(-1)[:n]
    _eq(P.probe_alu("shfl", _t(x), K), want)
    _eq(P.probe_alu("bar", _t(x), K),
        (x.astype(np.int64) + K).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("w", [128, 1024])
def test_p_gather(w):
    """probe_pallas.py:82 on the probe's tables, and on random indexes."""
    tbl = np.tile(np.arange(w, dtype=np.int32)[None, :] * 10, (8, 1))
    idx = np.zeros((8, w), np.int32)
    idx[:, :2] = [w - 24, w // 2]
    rnd = _rng(w).integers(0, w, (8, w)).astype(np.int32)
    for i in (idx, rnd):
        want = np.take_along_axis(tbl, i, axis=1)
        _eq(P.dep_gather_loop(_t(tbl), _t(i), 1), want)
        _eq(P.probe_chain("dep", _t(tbl), _t(i), 1), want)


def test_p_walk():
    """probe_pallas.py:107, its loop in Python ints with int32 wrap."""
    for x in (np.arange(1024, dtype=np.int32).reshape(8, 128),
              _i32(_rng(10), (8, 128))):
        acc = 0
        for i in range(4096):
            acc = (acc + int(x[acc % 8, i % 128]) + 2**31) % 2**32 - 2**31
        want = np.array([[acc]], np.int32)
        _eq(P.scalar_walk(_t(x)), want)
        _eq(P.probe_chain("walk", _t(x), None, 4096), want)


@pytest.mark.parametrize("B,keys", [
    pytest.param(1, "tpu", id="1"), pytest.param(32, "tpu", id="32"),
    pytest.param(1, "full", id="1-full"),
    pytest.param(32, "full", id="32-full")])
def test_p_bitonic_64k_sorts(B, keys):
    """probe_pallas.py:154 (one [512, 128] tile) and :186 / :225 (32 of
    them) through probe_bitonic_64k, in both shapes it takes: the TPU
    probe's keys (< 2^30), and full-range int32 keys with negatives and
    repeats, which k_bitonic orders as signed (jnp.minimum / maximum on
    int32).  The k_bitonic kernels are defined inside probe_pallas.main()
    and cannot be imported; np.sort is the check main() prints."""
    rng = _rng(B)
    if keys == "tpu":
        x = rng.integers(0, 1 << 30, (B, 512 * 128)).astype(np.int32)
    else:
        x = rng.integers(-2**31, 2**31, (B, 512 * 128)).astype(np.int32)
        x[:, 1::7] = x[:, ::7][:, :x[:, 1::7].shape[1]]
        x[:, 2::5] = rng.integers(-3, 3, x[:, 2::5].shape)
    want = np.sort(x, axis=1)
    _eq(P.probe_bitonic_64k(_t(x)), want)
    _eq(P.probe_bitonic_64k(_t(x).view(B, 512, 128)),
        want.reshape(B, 512, 128))


def test_p_bitonic_64k_shapes():
    """The 64K sort takes int32 [B, 512, 128] or [B, 65536]; any other
    shape or type is refused by name.  The card's plan: a row over a
    cluster of 16 CTAs of 4096 values, the network's 136 passes by where a
    pair meets (4 values a thread): 31 in registers, 60 by shuffles, 45
    past a warp, of which probe_bench counts the 10 past a CTA's values
    as exchanges across CTAs."""
    x = torch.zeros((2, 65536), dtype=torch.int32)
    for bad in (x[:, :4096], x.view(2, 128, 512), x.view(-1), x[None],
                x.view(2, 256, 256)):
        with pytest.raises(ValueError, match="64K sort takes"):
            P.probe_bitonic_64k(bad)
    with pytest.raises(ValueError, match="int32"):
        P.probe_bitonic_64k(x.to(torch.int64))
    assert P.probe_bitonic_64k(x[:0]).shape == (0, 65536)
    assert (P.ROW_N, P.ROW_CTAS) == (65536, 16)
    plan = P.bitonic_plan(P.ROW_N, P.ROW_N)
    assert (plan["v"], plan["stages"]) == (4, {"regs": 31, "shfl": 60,
                                               "smem": 45})
    case = next(c for c in PB.CASES if c.name == "probe_sort_1x65536")
    assert (case.cluster, case.args["seg_n"]) == (16, 65536)


@pytest.mark.parametrize("segment,axis", [("flat", None), ("rows", 1),
                                          ("cols", 0)])
def test_p_bitonic_segments(segment, axis):
    """probe_pallas3.py:77 (1024 flat), :113 (rows of 128), :145 (columns
    of 8) against np.sort, on two [8, 128] tiles: the TPU's p_bitonic,
    p_rows and p_cols are defined inside probe_pallas3.main() and cannot
    be imported, and np.sort is the check main() prints."""
    x = _i32(_rng(11), (2, 8, 128))
    want = np.stack([np.sort(t.reshape(-1)).reshape(8, 128) if axis is None
                     else np.sort(t, axis=axis) for t in x])
    _eq(P.bitonic(_t(x), segment), want)
    _eq(P.probe_bitonic(_t(x), segment), want)


def test_bitonic_and_indep_shapes_the_card_takes():
    """The card's BITONIC sorts tiles of 32 to 4096 elements, powers of 2
    on both axes; its INDEP takes tables a power of 2 wide, staged up to
    32768 words (a copy and W - 1 wrapped words in a CTA's shared memory),
    R copies of each word: 32 at the TPU probe's 128, 16 at the inflate's
    2048, 1 at 32768.  Anything else is refused by name."""
    for S, L in ((8, 128), (4, 8), (16, 64), (64, 64), (32, 1), (1, 4096)):
        P.bitonic_check(S, L)
    for bad in ((4, 4), (8, 1024), (3, 32), (8, 96), (0, 128)):
        with pytest.raises(ValueError, match="bitonic runs on the card"):
            P.bitonic_check(*bad)
    for w, W, smem in ((128, 4, True), (2048, 8, True), (32768, 8, True),
                       (1, 4, True), (65536, 8, False)):
        P.indep_check(w, W, smem)
    for w, W, smem in ((96, 4, True), (65536, 8, True), (0, 8, False),
                       (100, 8, False)):
        with pytest.raises(ValueError, match="indep runs on the card"):
            P.indep_check(w, W, smem)
    assert [P.indep_copies(w, 8) for w in (128, 2048, 8192, 32768)] == [
        32, 16, 4, 1]


def _chain_np(v: np.ndarray, i: np.ndarray, K: int) -> np.ndarray:
    for _ in range(K):
        i = np.take_along_axis(v, i & 127, axis=-1)
    return i


@pytest.mark.parametrize("grid", [None, 4])
def test_p_chain_and_grid(grid):
    """probe_pallas4.py:48 p_chain and :124 p_chain_grid (a leading grid
    dim), their body in numpy."""
    rng = _rng(12)
    shape = (16, 128) if grid is None else (grid, 16, 128)
    x = rng.integers(0, 1 << 20, shape).astype(np.int32)
    i = rng.integers(0, 128, shape).astype(np.int32)
    want = _chain_np(x, i, 16)
    _eq(P.chain16(_t(x), _t(i)), want)
    _eq(P.probe_chain("dep", _t(x), _t(i), 16), want)


def test_p_tbl():
    """probe_pallas4.py:79: tbl.flat[idx] for a 1024-entry table."""
    rng = _rng(13)
    tbl = rng.integers(0, 99, (8, 128)).astype(np.int32)
    i1 = rng.integers(0, 1024, (64, 128)).astype(np.int32)
    _eq(P.tbl1024(_t(tbl), _t(i1)), tbl.reshape(-1)[i1])
    _eq(P.probe_chain("dep", _t(tbl).reshape(1, -1), _t(i1), 1),
        tbl.reshape(-1)[i1])


# -- the bench's library calls: one PyTorch call, the same function ----------

_LIBRARY_CASES = [c for c in PB.CASES if c.library is not None]


@pytest.mark.parametrize("case", _LIBRARY_CASES,
                         ids=[c.name for c in _LIBRARY_CASES])
def test_bench_library_call_equals_plain(case):
    """Each PyTorch call that probe_bench times beside a probe computes
    what the probe's plain version does, on the case's own inputs."""
    x = case.make(torch.Generator().manual_seed(0))
    want = case.plain(x, case.k)
    got = case.library(x)
    assert torch.equal(got.reshape(want.shape).to(want.dtype), want)


def test_step5_shapes_the_card_takes():
    """STEP5's kernels are built for a 128-word window, 128 or 256 root
    cells, 256 subtable cells and 1, 8 or 32 lanes a CTA; any other shape
    is refused by name.  The token tile's buffers hold the tile where
    two fit in a CTA's shared memory and a tensor copy's box, else the
    largest divisor that does."""
    for rc in (128, 256):
        for lpc in P.STEP5_LPC:
            P.step5_check(128, rc, 256, lpc)
    for bad in ((64, 256, 256, 1), (128, 512, 256, 1), (128, 256, 128, 8),
                (128, 256, 256, 64), (128, 256, 256, 3), (128, 256, 256, 4)):
        with pytest.raises(ValueError, match="step5 runs on the card"):
            P.step5_check(*bad)
    assert [P.tokens_rows(256, lpc) for lpc in (4, 32, 64, 128)] == [
        256, 256, 256, 128]
    assert P.tokens_rows(8, 4) == 8 and P.tokens_rows(255, 128) == 85
    assert P.tokens_rows(512, 4) == 256   # a tensor copy's box


_STEP_CASES = [c for c in PB.CASES if "call" in c.args]


@pytest.mark.parametrize("case", _STEP_CASES,
                         ids=[c.name for c in _STEP_CASES])
def test_bench_step_cases_equal_plain(case):
    """Each case of probe_bench that its --against turns call through
    another checkout's wrapper (COLUMN, STEP3, STEP5, TOKENS, INDEP,
    BITONIC, WALK and the ALU chains), called so through this checkout's
    module on the CPU, equals its plain version at the case's K."""
    x = case.make(torch.Generator().manual_seed(0))
    got = case.args["call"](P, x, case.k)
    want = case.plain(x, case.k)
    got, want = ((got, want) if isinstance(want, tuple)
                 else ((got,), (want,)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
