"""The CUDA kernels' per-record and per-lane logic, built for the host.

``csrc/select.cuh``, ``csrc/inflate_step.cuh`` and ``csrc/sort.cuh`` hold
the logic of the kernels as ``__host__ __device__`` functions.  g++ builds
them here (with ``__host__``/``__device__`` defined away) into a small shim
library, and the shim is held exactly against the port's plain torch
versions, or numpy, on the same inputs.  The kernels themselves run only on
the card (chip_smoke.py).
"""
import ctypes
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from qatzip_tpu.ops import deflate_decode as rdd
from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import inflate as PI
from qatzip_tpu_torch.ops import match_finder as mf
from qatzip_tpu_torch.ops import select as SEL

torch.set_num_threads(1)

_SHIM = r"""
#include "select.cuh"
#include "inflate_step.cuh"
#include "sort.cuh"

extern "C" void shim_select(const uint32_t* sk, const uint32_t* sb4,
                            const uint32_t* sb4b, int32_t* out, int B, int n,
                            int depth) {
  for (int b = 0; b < B; ++b)
    for (int j = 0; j < n; ++j)
      out[b * n + j] = qz_select_one(sk + b * n, sb4 + b * n, sb4b + b * n,
                                     j, depth);
}

extern "C" int shim_inflate(const uint32_t* words, int nw,
                            const int32_t* bit0, const int32_t* nbits,
                            const uint32_t* tll, const uint32_t* td,
                            const int32_t* active, int lanes, int max_steps,
                            uint32_t* tokens, int32_t* err, int32_t* outcnt,
                            int32_t* end_bit) {
  int nsteps = 0;
  for (int lane = 0; lane < lanes; ++lane) {
    QzLane L = {words + lane * nw, nw, tll + lane * QZ_CELLS,
                td + lane * QZ_CELLS};
    int s = qz_inflate_lane(L, bit0[lane], nbits[lane], active[lane] != 0,
                            max_steps, tokens, lanes, lane, err + lane,
                            outcnt + lane, end_bit + lane);
    nsteps = s > nsteps ? s : nsteps;
  }
  return nsteps;
}

// The launch schedule of csrc/sort.cu run serially: tile passes on a
// tile-sized view of the row, global passes on the whole row.
static void tile_passes(QzSortRow row, uint32_t n, uint32_t k_merge) {
  for (uint32_t off = 0; off < n; off += QZ_SORT_TILE) {
    QzSortRow t = qz_sort_slice(row, off);
    uint32_t k_lo = k_merge ? k_merge : 2u;
    uint32_t k_hi = k_merge ? k_merge : (uint32_t)QZ_SORT_TILE;
    for (uint32_t k = k_lo; k <= k_hi; k <<= 1)
      for (uint32_t j = k_merge ? QZ_SORT_TILE / 2 : k / 2; j >= 1; j >>= 1)
        for (uint32_t p = 0; p < QZ_SORT_TILE / 2; ++p)
          qz_bitonic_pair(t, p, j, k);
  }
}

extern "C" void shim_sort(uint32_t* key, uint32_t* pay, uint32_t n) {
  QzSortRow row = {key, {pay, nullptr, nullptr, nullptr}, 1, 0};
  tile_passes(row, n, 0);
  for (uint32_t k = 2u * QZ_SORT_TILE; k <= n; k <<= 1) {
    for (uint32_t j = k / 2; j >= QZ_SORT_TILE; j >>= 1)
      for (uint32_t p = 0; p < n / 2; ++p) qz_bitonic_pair(row, p, j, k);
    tile_passes(row, n, k);
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available to build the host shim")
    d = tmp_path_factory.mktemp("shim")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    lib = d / "libshim.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-Wall", "-Werror", "-D__host__=",
                    "-D__device__=", f"-I{_build.CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.shim_inflate.restype = ctypes.c_int
    return so


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _sorted_arrays(corpus_factory):
    """The match finder's sort-1 output for a few 4 KB blocks."""
    n = 4096
    datas = [corpus_factory(n, k)
             for k in ("text", "constant", "iterative", "random")]
    arr = np.zeros((len(datas), n + 8), np.uint8)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
    lens = torch.full((len(datas),), n, dtype=torch.int32)
    return mf.sorted_records(torch.from_numpy(arr), lens, 1, True)


@pytest.mark.parametrize("depth", [4, 16])
def test_select_header_matches_torch_reference(shim, corpus_factory, depth):
    sk, sb4, sb4b = _sorted_arrays(corpus_factory)
    want = SEL.select_candidates_ref(sk, sb4, sb4b, depth).numpy()
    B, n = sk.shape
    out = np.zeros((B, n), np.int32)
    args = [np.ascontiguousarray(t.numpy()) for t in (sk, sb4, sb4b)]
    shim.shim_select(*(_ptr(a) for a in args), _ptr(out), B, n, depth)
    assert (out == want).all()
    assert (want > 0).any()


def _raw(data: bytes, level: int, strategy=zlib.Z_DEFAULT_STRATEGY) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


def _lanes(corpus_factory):
    """Three single-block streams (dynamic, static and a corrupt one) laid
    out as the lockstep round lays them out, on 4 lanes (one idle)."""
    lanes, NW = 4, 1024
    datas = [corpus_factory(1500, "text"), corpus_factory(700, "iterative")]
    payloads = [_raw(datas[0], 6), _raw(datas[1], 1, zlib.Z_FIXED)]
    stream8 = np.zeros((lanes, NW * 4), np.uint8)
    bit0 = np.zeros(lanes, np.int32)
    nbits = np.zeros(lanes, np.int32)
    tll = np.zeros((lanes, PI.CELLS), np.uint32)
    td = np.zeros((lanes, PI.CELLS), np.uint32)
    active = np.zeros(lanes, np.int32)
    for i, p in enumerate(payloads + [payloads[0]]):
        s = rdd._Stream(p, 0, i)
        assert rdd._parse_one_header(s) == "huff"
        if s._lens is None:
            tll[i], td[i] = PI.static_regions()
        else:
            tll[i] = PI.build_ll_region(s._lens[0])
            td[i] = PI.build_d_region(s._lens[1])
        byte0 = s.bits.pos >> 3
        pv = np.frombuffer(p, np.uint8)[byte0:]
        stream8[i, :len(pv)] = pv
        bit0[i] = s.bits.pos & 7
        nbits[i] = len(pv) * 8
        active[i] = 1
    stream8[2, 40:80] ^= 0xA5       # lane 2: a corrupted copy of lane 0
    return stream8.view("<u4"), bit0, nbits, tll, td, active, datas


def test_inflate_header_matches_torch_reference(shim, corpus_factory):
    words, bit0, nbits, tll, td, active, datas = _lanes(corpus_factory)
    lanes, nw = words.shape
    max_steps = 4096
    want = PI._decode_ref(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bit0),
        torch.from_numpy(nbits), torch.from_numpy(tll.view(np.int32)),
        torch.from_numpy(td.view(np.int32)), torch.from_numpy(active) != 0,
        max_steps)
    tokens = np.zeros((max_steps, lanes), np.uint32)
    err = np.zeros(lanes, np.int32)
    outcnt = np.zeros(lanes, np.int32)
    end_bit = np.zeros(lanes, np.int32)
    ns = shim.shim_inflate(_ptr(np.ascontiguousarray(words)), nw, _ptr(bit0),
                           _ptr(nbits), _ptr(tll), _ptr(td), _ptr(active),
                           lanes, max_steps, _ptr(tokens), _ptr(err),
                           _ptr(outcnt), _ptr(end_bit))
    assert ns == int(want[4][0])
    assert (tokens.view(np.int32) == want[0].numpy()).all()
    assert ((err != 0) == want[1].numpy()).all()
    assert (outcnt == want[2].numpy()).all()
    assert (end_bit == want[3].numpy()).all()
    # lanes 0/1 decode their data, lane 3 is idle
    assert list(err[:2]) == [0, 0] and outcnt[3] == 0 and end_bit[3] == -1
    for lane, data in enumerate(datas):
        got = rdd._apply_tokens_py(tokens[:ns, lane], b"", int(outcnt[lane]))
        assert got == data


@pytest.mark.parametrize("n", [1024, 4096])
def test_sort_header_network_matches_argsort(shim, n):
    rng = np.random.default_rng(n)
    pool = np.unique(rng.integers(0, 1 << 32, 2 * n, dtype=np.uint64))
    keys = rng.permutation(pool)[:n].astype(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    order = np.argsort(keys, kind="stable")
    k2, p2 = keys.copy(), pay.copy()
    shim.shim_sort(_ptr(k2), _ptr(p2), n)
    assert (k2 == keys[order]).all() and (p2 == pay[order]).all()
    assert (keys >= 1 << 31).any()


def test_kernel_wrapper_counts_accepted_launches_and_raises_on_error(
        monkeypatch):
    """A launch the CUDA runtime refuses raises KernelError and is not
    counted; an accepted launch counts once."""
    class Lib:
        @staticmethod
        def qz_cuda_error_string(rc):
            return b"invalid configuration argument"

    rcs = [0, 9]
    kern = _build.Kernel("qz_test_entry", [])
    monkeypatch.setattr(_build, "library", lambda: Lib)
    monkeypatch.setattr(kern, "_fn", lambda *a: rcs.pop(0))
    kern()
    assert kern.launches == 1
    with pytest.raises(_build.KernelError, match="CUDA error 9"):
        kern()
    assert kern.launches == 1
