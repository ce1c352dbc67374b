"""The CUDA kernels' per-record and per-lane logic, built for the host.

``csrc/select.cuh``, ``csrc/inflate_step.cuh``, ``csrc/sort.cuh``,
``csrc/lz4_block.cuh`` and ``tools/probes.cuh`` hold the logic of the
kernels as ``__host__ __device__`` functions.  g++ builds
them here (with ``__host__``/``__device__`` defined away) into a small shim
library, and the shim is held exactly against the port's plain torch
versions, or numpy, on the same inputs; the inflate shim also against the
reference's XLA driver, the LZ4 shim against the reference's XLA decoder
and the host decoder.  The kernels themselves run only on the card
(chip_smoke.py).
"""
import ctypes
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from qatzip_tpu.ops import deflate_decode as rdd
from qatzip_tpu.ops import lz4_decode as RLD
from qatzip_tpu.ops import pallas_inflate as RPI
from qatzip_tpu_torch.engine.lz4_block import (lz4_block_compress,
                                               lz4s_block_compress)
from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import inflate as PI
from qatzip_tpu_torch.ops import lz4_decode as LD
from qatzip_tpu_torch.ops import match_finder as mf
from qatzip_tpu_torch.ops import select as SEL
from qatzip_tpu_torch.tools import lz4_cases as LC
from qatzip_tpu_torch.tools import probes as PR

torch.set_num_threads(1)

_SHIM = r"""
#include "select.cuh"
#include "inflate_step.cuh"
#include "sort.cuh"
#include "probes.cuh"
#include "lz4_block.cuh"

#include <algorithm>
#include <vector>

// The launch of csrc/select.cu run serially, the kernel's schedule through
// select.cuh's own functions: each CTA (its QZ_SELECT_CTA_TILES tiles of a
// row) starts from two shared-memory buffers full of garbage and stages its
// first tile; then, a tile at a time, every thread stages its share of the
// next tile into the other buffer and every thread selects over the current
// one, as between the kernel's barriers.
template <int DEPTH, bool TO_POS>
static void select_launch(const QzSelectArgs& a, int B) {
  std::vector<qz_u4> buf(2 * QZ_SELECT_SMEM_WORDS / 4);
  uint32_t* sm[2] = {(uint32_t*)buf.data(),
                     (uint32_t*)buf.data() + QZ_SELECT_SMEM_WORDS};
  const int tiles = qz_select_tiles(a.n);
  for (int row = 0; row < B; ++row)
    for (int first = 0; first < tiles; first += QZ_SELECT_CTA_TILES) {
      const int end = std::min(first + QZ_SELECT_CTA_TILES, tiles);
      for (int w = 0; w < 2 * QZ_SELECT_SMEM_WORDS; ++w)
        sm[0][w] = 0xA5A5A5A5u;
      for (int t = 0; t < QZ_SELECT_THREADS; ++t)
        qz_select_stage(a, row, first, t, sm[0]);
      for (int tile = first; tile < end; ++tile) {
        const int p = (tile - first) & 1;
        for (int t = 0; t < QZ_SELECT_THREADS && tile + 1 < end; ++t)
          qz_select_stage(a, row, tile + 1, t, sm[p ^ 1]);
        for (int t = 0; t < QZ_SELECT_THREADS; ++t)
          qz_select_tile<DEPTH, TO_POS>(a, row, tile, t, sm[p]);
      }
    }
}

template <int DEPTH>
static int select_order(const QzSelectArgs& a, int B, int to_pos) {
  if (to_pos)
    select_launch<DEPTH, true>(a, B);
  else
    select_launch<DEPTH, false>(a, B);
  return 0;
}

// out: int32 [B, n] (to_pos 0) or zeroed uint16 [B, n_full] (to_pos 1).
// The kernel's depths, 4, 8, 12 and 16.  Returns 0, or -1 for another
// depth.
extern "C" int shim_select(const uint32_t* sk, const uint32_t* sb4,
                           const uint32_t* sb4b, void* out, int B, int n,
                           int n_full, int depth, int to_pos, int vec) {
  const QzSelectArgs a = {sk, sb4, sb4b, out, n, n_full, vec};
  switch (depth) {
    case 4: return select_order<4>(a, B, to_pos);
    case 8: return select_order<8>(a, B, to_pos);
    case 12: return select_order<12>(a, B, to_pos);
    case 16: return select_order<16>(a, B, to_pos);
  }
  return -1;
}

// The launch of csrc/inflate.cu run serially, through the kernel's own
// qz_stage_tables and qz_inflate_lane (lane loop, stream window, refills):
// every thread of a lane's CTA stages its share of the tables into the
// CTA's shared memory, which starts as garbage, before the lane decodes.
extern "C" int shim_inflate(const uint32_t* words, int nw,
                            const int32_t* bit0, const int32_t* nbits,
                            const uint32_t* tll, const uint32_t* td,
                            const int32_t* active, int lanes, int max_steps,
                            uint32_t* tokens, int32_t* err, int32_t* outcnt,
                            int32_t* end_bit) {
  const QzInflateArgs a = {words, nw, bit0, nbits, tll, td, active, lanes,
                           max_steps, tokens, err, outcnt, end_bit};
  std::vector<uint32_t> smem(QZ_SMEM_WORDS);
  int nsteps = 0;
  for (int lane = 0; lane < lanes; ++lane) {
    for (uint32_t& w : smem) w = 0xA5A5A5A5u;
    for (int t = 0; t < QZ_CTA_THREADS; ++t)
      qz_stage_tables(a, lane, t, smem.data());
    const int s = qz_inflate_lane(a, lane, smem.data());
    nsteps = s > nsteps ? s : nsteps;
  }
  return nsteps;
}

// The launch of csrc/lz4_block.cu run serially, through lz4_block.cuh's
// own qz_lz4_row: a warp whose 32 lanes run in turn at each step of the
// schedule (a literal or match copy, a ballot over a length extension's
// bytes), so a lane reads only what the lanes before a __syncwarp wrote.
struct QzHostWarp {
  template <class F>
  void each(F f) {
    for (int lane = 0; lane < QZ_LZ4_LANES; ++lane) f(lane);
  }
  void sync() {}
  template <class F>
  uint32_t ballot(F f) {
    uint32_t mask = 0;
    for (int lane = 0; lane < QZ_LZ4_LANES; ++lane)
      if (f(lane)) mask |= 1u << lane;
    return mask;
  }
};

extern "C" void shim_lz4(const uint8_t* in, const int32_t* len, int rows,
                         int n, int outcap, int lz4s, int base, uint8_t* out,
                         int32_t* tot, uint8_t* err) {
  const QzLz4Args a = {in, len, rows, n, outcap, lz4s, base, out, tot, err};
  QzHostWarp w;
  for (int r = 0; r < rows; ++r) qz_lz4_row(a, r, w);
}

// The launches of csrc/sort.cu run serially, through sort.cuh's own walkers
// (qz_sort_launches, qz_sort_walk); only the per-level bodies are the
// shim's.  Each CTA's shared memory is an array of its own, filled with
// records at qz_sort_swz's places as the kernel fills it; a register step
// runs every group of every CTA in turn, and a cluster pass reads a
// snapshot, as if every slot read before any wrote.
template <int NPAY, int W>
static void regs_step(uint32_t* sm, const QzSortPlan& pl, uint32_t cta0,
                      const QzSortStep& st) {
  if constexpr (W > 1) {
    if (st.w < W) {
      regs_step<NPAY, W - 1>(sm, pl, cta0, st);
      return;
    }
  }
  const uint32_t rec = qz_sort_rec_words(NPAY);
  for (uint32_t q = 0; q < (pl.m >> W); ++q) {
    const uint32_t base = qz_sort_group_base(q, st.g, W);
    uint32_t p[1 << W];
    qz_sort_group_slots<W>(base, st.g, p);
    QzSortRec<NPAY> r[1 << W];
    for (int s = 0; s < (1 << W); ++s) {
      r[s].key = sm[rec * p[s]];
      for (int c = 0; c < NPAY; ++c) r[s].pay[c] = sm[rec * p[s] + 1 + c];
    }
    qz_sort_group<NPAY, W>(r, cta0 | base, st);
    for (int s = 0; s < (1 << W); ++s) {
      sm[rec * p[s]] = r[s].key;
      for (int c = 0; c < NPAY; ++c) sm[rec * p[s] + 1 + c] = r[s].pay[c];
    }
  }
}

template <int NPAY>
static void cluster_launch(uint32_t* const* arr, uint32_t n,
                           const QzSortPlan& pl, uint32_t k_merge) {
  const uint32_t rec = qz_sort_rec_words(NPAY);
  const uint32_t words = rec * pl.m;
  std::vector<uint32_t> sm(pl.c * words);
  for (uint32_t seg0 = 0; seg0 < n; seg0 += pl.span) {
    for (uint32_t r = 0; r < pl.c; ++r)
      for (int a = 0; a <= NPAY; ++a)
        for (uint32_t i = 0; i < pl.m; ++i)
          sm[r * words + rec * qz_sort_swz(i) + a] =
              arr[a][seg0 + r * pl.m + i];
    QzSortStep st;
    for (QzSortWalk w = qz_sort_walk(pl, k_merge); qz_sort_next(&w, &st);) {
      if (st.level == QZ_SORT_CLUSTER) {
        const std::vector<uint32_t> old(sm);
        for (uint32_t r = 0; r < pl.c; ++r) {
          const uint32_t cta0 = seg0 + r * pl.m;
          const uint32_t o = r ^ (st.j / pl.m);
          for (uint32_t i = 0; i < pl.m; ++i) {
            const uint32_t p = rec * qz_sort_swz(i);
            if (qz_sort_take(old[r * words + p], old[o * words + p],
                             (cta0 & st.j) != 0u,
                             qz_bitonic_ascending(cta0, st.k)))
              for (int a = 0; a <= NPAY; ++a)
                sm[r * words + p + a] = old[o * words + p + a];
          }
        }
      } else {
        for (uint32_t r = 0; r < pl.c; ++r) {
          uint32_t* s = &sm[r * words];
          const uint32_t cta0 = seg0 + r * pl.m;
          regs_step<NPAY, QZ_SORT_LOG_E>(s, pl, cta0, st);
        }
      }
    }
    for (uint32_t r = 0; r < pl.c; ++r)
      for (int a = 0; a <= NPAY; ++a)
        for (uint32_t i = 0; i < pl.m; ++i)
          arr[a][seg0 + r * pl.m + i] =
              sm[r * words + rec * qz_sort_swz(i) + a];
  }
}

template <int NPAY>
static void sort_row(uint32_t* key, uint32_t* pays, uint32_t n) {
  uint32_t* arr[1 + QZ_SORT_MAX_PAYLOADS] = {key};
  QzSortRow row = {key, {nullptr, nullptr, nullptr, nullptr}, NPAY};
  for (int a = 0; a < NPAY; ++a) arr[1 + a] = row.pay[a] = pays + a * n;
  const QzSortPlan pl = qz_sort_plan(n, NPAY);
  qz_sort_launches(
      n, pl,
      [&](uint32_t k_merge) {
        cluster_launch<NPAY>(arr, n, pl, k_merge);
        return true;
      },
      [&](uint32_t k, uint32_t j) {
        for (uint32_t p = 0; p < n / 2; ++p) qz_bitonic_pair(row, p, j, k);
        return true;
      });
}

extern "C" void shim_sort(uint32_t* key, uint32_t* pays, int npay,
                          uint32_t n) {
  switch (npay) {
    case 0: sort_row<0>(key, pays, n); break;
    case 1: sort_row<1>(key, pays, n); break;
    case 2: sort_row<2>(key, pays, n); break;
    case 3: sort_row<3>(key, pays, n); break;
    default: sort_row<4>(key, pays, n); break;
  }
}

// The passes the launches of one row run, in order: (k, j, level) each, and
// the steps at each level.  Returns the number of passes.
extern "C" int shim_schedule(uint32_t n, int npay, uint32_t* out,
                             int* steps) {
  const QzSortPlan pl = qz_sort_plan(n, npay);
  int np = 0;
  auto pass = [&](uint32_t k, uint32_t j, int level) {
    out[3 * np] = k;
    out[3 * np + 1] = j;
    out[3 * np + 2] = (uint32_t)level;
    ++np;
  };
  qz_sort_launches(
      n, pl,
      [&](uint32_t k_merge) {
        QzSortStep st;
        QzSortWalk w = qz_sort_walk(pl, k_merge);
        for (uint32_t k = w.k, j = w.j; qz_sort_next(&w, &st);) {
          ++steps[st.level];
          while (k != w.k || j != w.j) {   // the step's passes
            pass(k, j, st.level);
            if (j == 1u) { k <<= 1; j = k >> 1; } else { j >>= 1; }
          }
        }
        return true;
      },
      [&](uint32_t k, uint32_t j) {
        pass(k, j, QZ_SORT_GLOBAL);
        ++steps[QZ_SORT_GLOBAL];
        return true;
      });
  return np;
}

// The most threads of one warp that reach one shared-memory bank at once,
// over every access of a row's cluster launch: each register step's group
// slots (a warp's lanes take consecutive groups), the cluster passes (32
// consecutive elements) and the 16-byte copies (32 consecutive vectors).
static int ways(const uint32_t* word) {
  int most = 0;
  for (int b = 0; b < 32; ++b) {
    int c = 0;
    for (int t = 0; t < 32; ++t) c += (word[t] & 31u) == (uint32_t)b;
    most = c > most ? c : most;
  }
  return most;
}

template <int W>
static int group_ways(uint32_t m, int g, int w, uint32_t rec) {
  if constexpr (W > 1) {
    if (w < W) return group_ways<W - 1>(m, g, w, rec);
  }
  int most = 0;
  for (uint32_t q0 = 0; q0 < (m >> W); q0 += 32) {
    uint32_t p[32][1 << W];
    for (int t = 0; t < 32; ++t)
      qz_sort_group_slots<W>(qz_sort_group_base(q0 + t, g, W), g, p[t]);
    for (int s = 0; s < (1 << W); ++s) {
      uint32_t word[32];
      for (int t = 0; t < 32; ++t) word[t] = rec * p[t][s];
      most = ways(word) > most ? ways(word) : most;
    }
  }
  return most;
}

extern "C" int shim_bank_ways(uint32_t n, int npay) {
  const QzSortPlan pl = qz_sort_plan(n, npay);
  const uint32_t rec = qz_sort_rec_words(npay);
  int most = 0;
  QzSortStep st;
  for (QzSortWalk walk = qz_sort_walk(pl, 0u); qz_sort_next(&walk, &st);) {
    int w = 0;
    if (st.level == QZ_SORT_REGS)
      w = group_ways<QZ_SORT_LOG_E>(pl.m, st.g, st.w, rec);
    most = w > most ? w : most;
  }
  for (uint32_t i0 = 0; i0 < pl.m; i0 += 32) {
    uint32_t word[32], copy[4][32];
    for (uint32_t t = 0; t < 32; ++t) {
      word[t] = rec * qz_sort_swz(i0 + t);
      for (uint32_t e = 0; e < 4; ++e)
        copy[e][t] = rec * qz_sort_swz((4 * (i0 + t) + e) % pl.m);
    }
    most = ways(word) > most ? ways(word) : most;
    for (int e = 0; e < 4; ++e)
      most = ways(copy[e]) > most ? ways(copy[e]) : most;
  }
  return most;
}

// The construct probes' loops (tools/probes.cu) run serially over host
// arrays through probes.cuh's steps: a lane at a time, K steps.
extern "C" void shim_alu(int mode, uint32_t* x, int n, int K) {
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < K; ++k)
      x[i] = mode == 0 ? qzp_hash_step(x[i])
             : mode == 1 ? qzp_ew_step(x[i]) : qzp_double_step(x[i]);
}

// DEP (W 0) or INDEP<W> over [rows, cols] indexes, a [t_rows, w] table
extern "C" void shim_rows(int W, const uint32_t* t, int t_rows, int w,
                          uint32_t* idx, int rows, int cols, int K) {
  for (int r = 0; r < rows; ++r) {
    const uint32_t* row = t + (t_rows == 1 ? 0 : r) * w;
    for (int j = 0; j < cols; ++j) {
      uint32_t v = idx[r * cols + j];
      for (int k = 0; k < K; ++k)
        v = W == 0 ? qzp_dep_step(row, v, w - 1)
            : W == 4 ? qzp_indep_step<4>(row, v, w - 1)
                     : qzp_indep_step<8>(row, v, w - 1);
      idx[r * cols + j] = v;
    }
  }
}

// COLUMN over an [n, L] table and [rows, L] indexes
extern "C" void shim_column(const uint32_t* t, int n, int L, uint32_t* idx,
                            int rows, int K, uint32_t post) {
  for (int i = 0; i < rows * L; ++i)
    for (int k = 0; k < K; ++k)
      idx[i] = qzp_column_step(t + i % L, L, idx[i], n - 1, post);
}

extern "C" uint32_t shim_walk(const uint32_t* x, int rows, int cols, int K) {
  uint32_t acc = 0;
  for (int k = 0; k < K; ++k) acc = qzp_walk_step(x, rows, cols, acc, k);
  return acc;
}

// STEP3 over [lanes / 128, 128] row arrays; state becomes acc + bitpos
extern "C" void shim_step3(const int32_t* win, const int32_t* tll,
                           const int32_t* td, int32_t* state, int lanes,
                           int K) {
  for (int l = 0; l < lanes; ++l) {
    const int row = (l >> 7) << 7;
    int32_t bp = state[l], acc = 0;
    for (int k = 0; k < K; ++k)
      qzp_step3(win + row, tll + row, td + row, 1, bp, acc);
    state[l] = (int32_t)((uint32_t)acc + (uint32_t)bp);
  }
}

// STEP5 over columns (win [W, lanes], tll and td [rc + sc, lanes]); bp
// advances, the tokens go to toks [K, lanes]
extern "C" void shim_step5(const uint32_t* win, const uint32_t* tll,
                           const uint32_t* td, int32_t* bp, uint32_t* toks,
                           int lanes, int K, int W, int rc, int sc,
                           int rbits) {
  const QzpStep5 p = {W, rc, sc, rbits};
  for (int l = 0; l < lanes; ++l)
    for (int k = 0; k < K; ++k)
      toks[k * lanes + l] =
          qzp_step5(win + l, tll + l, td + l, lanes, p, bp[l]);
}

// The places a stage (k, j) of the BITONIC network touches: lo, hi and
// asc of each of a tile's n / 2 pairs, and the network run on each tile of
// x, a pair at a time
extern "C" void shim_bitonic_stage(uint32_t n, uint32_t seg_n,
                                   uint32_t seg_stride, uint32_t elem_stride,
                                   uint32_t k, uint32_t j, uint32_t* out) {
  const QzpSegments g = {seg_n, seg_stride, elem_stride};
  for (uint32_t p = 0; p < n / 2; ++p) {
    bool asc;
    qzp_bitonic_pair(g, p, k, j, out + 3 * p, out + 3 * p + 1, &asc);
    out[3 * p + 2] = asc;
  }
}

extern "C" void shim_bitonic(int32_t* x, int tiles, uint32_t n,
                             uint32_t seg_n, uint32_t seg_stride,
                             uint32_t elem_stride) {
  const QzpSegments g = {seg_n, seg_stride, elem_stride};
  for (int t = 0; t < tiles; ++t)
    for (uint32_t k = 2; k <= seg_n; k <<= 1)
      for (uint32_t j = k >> 1; j > 0; j >>= 1)
        for (uint32_t p = 0; p < n / 2; ++p) {
          uint32_t lo, hi;
          bool asc;
          qzp_bitonic_pair(g, p, k, j, &lo, &hi, &asc);
          qzp_compare_exchange(x + t * n, lo, hi, asc);
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
                    "-D__device__=", f"-I{_build.CSRC}", f"-I{_build.TOOLS}",
                    str(src), "-o", str(lib)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.shim_inflate.restype = ctypes.c_int
    so.shim_lz4.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3
    so.shim_select.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    so.shim_sort.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_uint32]
    so.shim_schedule.argtypes = [ctypes.c_uint32, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p]
    so.shim_bank_ways.argtypes = [ctypes.c_uint32, ctypes.c_int]
    so.shim_alu.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
    so.shim_rows.argtypes = [ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3
    so.shim_column.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_uint32]
    so.shim_walk.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    so.shim_walk.restype = ctypes.c_uint32
    so.shim_step3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    so.shim_step5.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    so.shim_bitonic_stage.argtypes = [ctypes.c_uint32] * 6 + [
        ctypes.c_void_p]
    so.shim_bitonic.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_uint32] * 4
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


def _shim_select(shim, sk, sb4, sb4b, depth: int, n_full: int | None = None,
                 vec: bool | None = None) -> np.ndarray:
    """The select launch through the shim: sorted order, or position order
    in a uint16 [B, n_full] row.  ``vec`` (16-byte staging) defaults to
    what the kernel's entry takes for these arrays."""
    B, n = sk.shape
    args = [np.ascontiguousarray(t.numpy()) for t in (sk, sb4, sb4b)]
    if vec is None:
        vec = n % 4 == 0 and all(a.ctypes.data % 16 == 0 for a in args)
    out = (np.zeros((B, n), np.int32) if n_full is None
           else np.zeros((B, n_full), np.uint16))
    rc = shim.shim_select(*(_ptr(a) for a in args), _ptr(out), B, n,
                          n_full or n, depth, n_full is not None, int(vec))
    assert rc == 0
    return out


@pytest.mark.parametrize("depth", [4, 16])
def test_select_header_matches_torch_reference(shim, corpus_factory, depth):
    sk, sb4, sb4b = _sorted_arrays(corpus_factory)
    want = SEL.select_candidates_ref(sk, sb4, sb4b, depth).numpy()
    for vec in (True, False):
        assert (_shim_select(shim, sk, sb4, sb4b, depth, vec=vec)
                == want).all()
    assert (want > 0).any()


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("depth", [8, 12, 16])
def test_select_header_to_positions_matches_torch_reference(
        shim, corpus_factory, depth, stride):
    """The position-order entry: 4 KB blocks (4 CTAs of 2 tiles at stride
    1, 2 at stride 2; 1365 records at stride 3, staged word by word), with a
    short block whose invalid tail sorts last."""
    n = 4096
    datas = [corpus_factory(n, k)
             for k in ("text", "constant", "iterative", "random")]
    datas.append(corpus_factory(1500, "text"))
    arr = np.zeros((len(datas), n + 8), np.uint8)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
    data = torch.from_numpy(arr)
    lens = torch.tensor([len(d) for d in datas], dtype=torch.int32)
    sk, sb4, sb4b = mf.sorted_records(data, lens, stride, True)
    want = SEL.select_to_positions_ref(sk, sb4, sb4b, depth, n).numpy()
    assert (want == mf.find_candidates(data, lens, depth,
                                       stride=stride).numpy()).all()
    got = _shim_select(shim, sk, sb4, sb4b, depth, n_full=n)
    assert (got == want).all()
    assert (want > 0).sum() > n // stride


def _runs(seed: int, B: int = 3, n: int = 5000, run: int = 40):
    """Sorted rows of hash runs longer than the look-back (``run`` records
    a hash), positions spread over 64 K so that distances pass 32767 inside
    a run, prefix words from a small set so that 3-, 4- and 8-byte matches
    mix, and invalid tails of 0, 100 and 1000 records.  5000 records a row
    take 5 CTAs, the last of one tile; all but the first start on a halo of
    real records."""
    rng = np.random.default_rng(seed)
    rows = []
    for b, tail in zip(range(B), (0, 100, 1000)):
        valid = n - tail
        pos = np.sort(rng.choice(65536, valid, replace=False))
        h = np.sort(rng.integers(0, 1 << 15, -(-valid // run)))
        hs = np.repeat(h, run)[:valid]
        key = (hs.astype(np.uint64) << 16) | pos.astype(np.uint64)
        lo3 = rng.integers(0, 3, valid).astype(np.uint64)
        b4 = (rng.integers(0, 2, valid).astype(np.uint64) << 24) | lo3
        b4b = rng.integers(0, 2, valid).astype(np.uint64)
        order = np.argsort(key, kind="stable")
        pad = np.full(tail, 0xFFFFFFFF, np.uint64)
        rows.append([np.concatenate([a[order], pad if i == 0 else pad * 0])
                     for i, a in enumerate((key, b4, b4b))])
    return [torch.from_numpy(np.stack([r[i] for r in rows])
                             .astype(np.uint32).view(np.int32))
            for i in range(3)]


@pytest.mark.parametrize("depth", [8, 12, 16])
def test_select_header_long_runs_and_invalid_tails(shim, depth):
    """Rows whose hash runs outlast the look-back and cross the tiles'
    halos, with distances past the window and invalid tails: the early
    exits equal the plain version, in both orders."""
    sk, sb4, sb4b = _runs(depth)
    want = SEL.select_candidates_ref(sk, sb4, sb4b, depth).numpy()
    assert (_shim_select(shim, sk, sb4, sb4b, depth) == want).all()
    assert (want > 0).sum() > 1000 and (want == 0).sum() > 1000
    want_pos = SEL.select_to_positions_ref(sk, sb4, sb4b, depth,
                                           65536).numpy()
    assert (_shim_select(shim, sk, sb4, sb4b, depth, n_full=65536)
            == want_pos).all()


def _raw(data: bytes, level: int, strategy=zlib.Z_DEFAULT_STRATEGY) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


def _layout(streams, lanes: int, nw: int, corrupt=(), idle=()):
    """Lay out single-block streams (rdd._Stream after their header) over
    ``lanes`` lanes as the lockstep round does, stream i on lane i modulo
    len(streams); ``corrupt`` lanes get bytes 40..79 flipped and ``idle``
    lanes stay inactive."""
    stream8 = np.zeros((lanes, nw * 4), np.uint8)
    bit0 = np.zeros(lanes, np.int32)
    nbits = np.zeros(lanes, np.int32)
    tll = np.zeros((lanes, PI.CELLS), np.uint32)
    td = np.zeros((lanes, PI.CELLS), np.uint32)
    active = np.zeros(lanes, np.int32)
    for i in range(lanes):
        s, pv = streams[i % len(streams)]
        if s._lens is None:
            tll[i], td[i] = PI.static_regions()
        else:
            tll[i] = PI.build_ll_region(s._lens[0])
            td[i] = PI.build_d_region(s._lens[1])
        stream8[i, :len(pv)] = pv
        bit0[i] = s.bits.pos & 7
        nbits[i] = len(pv) * 8
        active[i] = i not in idle
    for i in corrupt:
        stream8[i, 40:80] ^= 0xA5
    return stream8.view("<u4"), bit0, nbits, tll, td, active


def _block(payload: bytes, keep: int | None = None):
    """The stream after its first block header and its bytes from there
    (the first ``keep`` of them, when given)."""
    s = rdd._Stream(payload, 0, 0)
    assert rdd._parse_one_header(s) == "huff"
    pv = np.frombuffer(payload, np.uint8)[s.bits.pos >> 3:]
    return s, pv[:keep]


def _xla_ref(inputs, max_steps: int):
    """The reference's XLA driver on the same round, padded with inactive
    lanes to its 128: (tokens[:nsteps], err, outcnt, end_bit, nsteps) of
    the round's own lanes."""
    words, bit0, nbits, tll, td, active = inputs
    lanes = words.shape[0]
    pad = max(0, RPI.LANES - lanes)

    def padded(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    tokens, err, outcnt, end_bit, ns = RPI.decode_blocks(
        padded(words), padded(bit0), padded(nbits), padded(tll), padded(td),
        padded(active) != 0, max_steps, use_pallas=False)
    return (tokens[:, :lanes], err[:lanes], outcnt[:lanes], end_bit[:lanes],
            ns)


def _shim_vs_ref(shim, inputs, max_steps: int):
    """Run the shim, the plain torch driver and the reference's XLA driver
    on one round; assert the five outputs equal and return the shim's
    (tokens, err, outcnt, end_bit, nsteps)."""
    words, bit0, nbits, tll, td, active = inputs
    lanes, nw = words.shape
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
    ref = _xla_ref(inputs, max_steps)
    assert ns == ref[4]
    assert (tokens[:ns] == ref[0]).all()
    assert ((err != 0) == ref[1]).all()
    assert (outcnt == ref[2]).all()
    assert (end_bit == ref[3]).all()
    return tokens, err, outcnt, end_bit, ns


# a few lanes, one idle; more lanes than a warp has, not a multiple of 32
@pytest.mark.parametrize("lanes", [4, 37])
def test_inflate_header_matches_torch_reference(shim, corpus_factory, lanes):
    """Dynamic, static and corrupted lanes, every fourth lane idle."""
    datas = [corpus_factory(1500, "text"), corpus_factory(700, "iterative")]
    streams = [_block(_raw(datas[0], 6)), _block(_raw(datas[1], 1,
                                                      zlib.Z_FIXED))]
    streams += [streams[0], streams[0]]
    inputs = _layout(streams, lanes, 1024,
                     corrupt=range(2, lanes, 4), idle=range(3, lanes, 4))
    tokens, err, outcnt, end_bit, ns = _shim_vs_ref(shim, inputs, 4096)
    for lane in range(lanes):
        if lane % 4 == 3:
            assert (err[lane], outcnt[lane], end_bit[lane]) == (0, 0, -1)
        elif lane % 4 < 2:
            data = datas[lane % 4]
            assert not err[lane]
            assert rdd._apply_tokens_py(tokens[:ns, lane], b"",
                                        int(outcnt[lane])) == data


def test_inflate_header_lanes_past_their_stream(shim, corpus_factory):
    """Lanes cut short inside their block decode past the end of their
    stream; with the words a lane tight, the window reaches the driver's
    clamp (word index nw - 3), where the peek re-reads the last words.  The
    kernel's window must give the plain driver's and the reference XLA
    driver's tokens there too, and the
    same lanes decode differently with room to spare (so the clamp ran)."""
    payload = _raw(corpus_factory(3000, "text"), 6)
    keeps = [97, 98, 99, 100, 150, 151, 152, 153]
    streams = [_block(payload, k) for k in keeps]
    tight = (max(keeps) + 3) // 4 + 2
    runs = [_shim_vs_ref(shim, _layout(streams, len(keeps), nw), 512)
            for nw in (tight, tight + 8)]
    for tokens, err, *_ in runs:
        assert err.all()
    assert not np.array_equal(runs[0][0], runs[1][0])


def test_inflate_header_random_tables(shim):
    """Random table cells and stream words: entries of every kind and
    field (subtable pointers past the subtable area, distance symbols 30
    and 31), so the kernel's widened entries, lookups and clamps must give
    the plain driver's and the reference XLA driver's result for any input,
    not only for a builder's."""
    rng = np.random.default_rng(5)
    lanes, nw = 24, 64
    words = rng.integers(0, 1 << 32, (lanes, nw), dtype=np.uint64)
    tll, td = (rng.integers(0, 1 << 32, (lanes, PI.CELLS), dtype=np.uint64)
               .astype(np.uint32) for _ in range(2))
    bit0 = rng.integers(0, 8, lanes).astype(np.int32)
    nbits = np.full(lanes, (nw - 2) * 32, np.int32)
    inputs = (words.astype(np.uint32), bit0, nbits, tll, td,
              np.ones(lanes, np.int32))
    tokens, err, *_ = _shim_vs_ref(shim, inputs, 64)
    assert (tokens != 0).any() and err.any()


def _sort_inputs(n: int, npay: int, seed: int):
    """Unique u32 keys across the whole range (ties when keys go alone) and
    npay payload rows."""
    rng = np.random.default_rng(seed)
    if npay:
        lo = rng.permutation(n).astype(np.uint64)
        keys = (rng.integers(0, (1 << 32) // n, n, dtype=np.uint64) * n
                + lo).astype(np.uint32)
    else:
        keys = (rng.integers(0, 64, n, dtype=np.uint64) * 0x05F5E1
                + (1 << 31)).astype(np.uint32)
    pays = rng.integers(0, 1 << 32, (max(npay, 1), n),
                        dtype=np.uint64).astype(np.uint32)
    return keys, pays


# CTAs a cluster: 1 (1024, 4096), 2 (32768 with 2 payloads), 4 (32768 with
# 3, 65536 with 1-2), 8 (65536 with 4); beyond one cluster: 262144 with 2
# payloads, 131072 with 4
@pytest.mark.parametrize("n,npay", [
    (1024, 0), (4096, 2), (32768, 0), (32768, 2), (65536, 2), (65536, 4),
    (262144, 2), (131072, 4), (65536, 1), (32768, 3)])
def test_sort_header_network_matches_argsort(shim, n, npay):
    keys, pays = _sort_inputs(n, npay, seed=n + npay)
    k2, p2 = keys.copy(), pays.copy()
    shim.shim_sort(_ptr(k2), _ptr(p2), npay, n)
    assert (keys >= 1 << 31).any()
    if not npay:
        assert (k2 == np.sort(keys)).all()
        return
    order = np.argsort(keys, kind="stable")
    assert (k2 == keys[order]).all()
    assert (p2[:npay] == pays[:npay][:, order]).all()


def _network(n: int):
    return [(k, j) for s in range(1, n.bit_length())
            for k in [1 << s] for j in (k >> c for c in range(1, s + 1))]


# (n, npay): the steps at each level (registers, cluster, global)
@pytest.mark.parametrize("n,npay,steps", [
    (1024, 2, [15, 0, 0]), (32768, 2, [33, 1, 0]), (65536, 2, [37, 3, 0]),
    (65536, 4, [37, 6, 0]), (262144, 2, [45, 9, 1])])
def test_sort_schedule_runs_the_network_in_order(shim, n, npay, steps):
    out = np.zeros((n.bit_length() ** 2, 3), np.uint32)
    got = np.zeros(3, np.int32)
    np_ = shim.shim_schedule(n, npay, _ptr(out), _ptr(got))
    assert [tuple(map(int, r[:2])) for r in out[:np_]] == _network(n)
    m = {2: 16384, 4: 8192}[npay]
    span = min(n, 8 * m)
    for k, j, level in out[:np_]:
        assert level == (2 if j >= span else 1 if j >= m else 0)
    assert list(got) == steps


# records of 1, 3 and 5 words, and of 2 and 4 padded to 3 and 5, in CTAs of
# 1024, 8192 and as many elements as fit
@pytest.mark.parametrize("n", [1024, 8192, 65536])
@pytest.mark.parametrize("npay", [0, 1, 2, 3, 4])
def test_sort_shared_memory_has_no_bank_conflicts(shim, n, npay):
    assert shim.shim_bank_ways(n, npay) == 1


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
    monkeypatch.setattr(_build, "library", lambda name=_build.KERNELS: Lib)
    monkeypatch.setattr(kern, "_fn", lambda *a: rcs.pop(0))
    kern()
    assert kern.launches == 1
    with pytest.raises(_build.KernelError, match="CUDA error 9"):
        kern()
    assert kern.launches == 1


def _u32s(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _ti(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("mode,plain", [(0, PR.elemwise_loop), (1, PR.ew),
                                        (2, PR.double)])
def test_probe_alu_steps_match_plain(shim, mode, plain):
    x = _u32s(np.random.default_rng(mode), 4096)
    got = x.copy()
    shim.shim_alu(mode, _ptr(got), x.size, 9)
    assert (got.view(np.int32) == plain(_ti(x), 9).numpy()).all()


# dependent and independent lookups; a row a lane's index row, and one
# 2048-word table (the inflate's 8 KB a lane) for every row
@pytest.mark.parametrize("W", [0, 4, 8])
@pytest.mark.parametrize("w,t_rows", [(128, 6), (2048, 1)])
def test_probe_row_chains_match_plain(shim, W, w, t_rows):
    rng = np.random.default_rng(w + W)
    t, idx = _u32s(rng, (t_rows, w)), _u32s(rng, (6, 40))
    got = idx.copy()
    shim.shim_rows(W, _ptr(t), t_rows, w, _ptr(got), 6, 40, 7)
    want = (PR.dep_gather_loop(_ti(t), _ti(idx), 7) if W == 0 else
            PR.indep_gather_loop(_ti(t), _ti(idx), 7, W))
    assert (got.view(np.int32) == want.numpy()).all()


@pytest.mark.parametrize("n,post", [(8, 0xFFFFFFFF), (512, 511)])
def test_probe_column_and_walk_match_plain(shim, n, post):
    rng = np.random.default_rng(n)
    t, idx = _u32s(rng, (n, 64)), _u32s(rng, (8, 64))
    got = idx.copy()
    shim.shim_column(_ptr(t), n, 64, _ptr(got), 8, 11, post)
    want = PR._column(_ti(t), _ti(idx), 11, post)
    assert (got.view(np.int32) == want.numpy()).all()
    x = _u32s(rng, (8, 128))
    acc = shim.shim_walk(_ptr(x), 8, 128, 500)
    assert np.uint32(acc).view(np.int32) == int(PR.scalar_walk(_ti(x), 500))


def test_probe_step3_matches_plain(shim):
    """The step_loop skeleton on random tables and windows over the whole
    int32 range, 3 rows of 128 lanes."""
    rng = np.random.default_rng(3)
    win, tll, td = (_u32s(rng, (3, 128)).view(np.int32) for _ in range(3))
    state = rng.integers(0, 1 << 20, (3, 128)).astype(np.int32)
    got = state.copy()
    shim.shim_step3(_ptr(win), _ptr(tll), _ptr(td), _ptr(got), 384, 20)
    want = PR.step_loop(*map(_ti, (win, tll, td, state)), 20)
    assert (got == want.numpy()).all()


@pytest.mark.parametrize("rc", [128, 256])
def test_probe_step5_matches_plain(shim, rc):
    """The lane-major skeleton on random cells: bitpos and every token."""
    rng = np.random.default_rng(rc)
    W, sc, lanes, K = 128, 256, 64, 12
    win = _u32s(rng, (W, lanes))
    tll, td = _u32s(rng, (rc + sc, lanes)), _u32s(rng, (rc + sc, lanes))
    bp = rng.integers(-2000, 1 << 20, (1, lanes)).astype(np.int32)
    got, toks = bp.copy(), np.zeros((K, lanes), np.uint32)
    rbits = (2 * rc).bit_length() - 1
    shim.shim_step5(_ptr(win), _ptr(tll), _ptr(td), _ptr(got), _ptr(toks),
                    lanes, K, W, rc, sc, rbits)
    want_bp, want_toks = PR.lane_major_step(*map(_ti, (win, tll, td, bp)), K,
                                            rc, sc)
    assert (got == want_bp.numpy()).all()
    assert (toks.view(np.int32) == want_toks.numpy()).all()
    assert len(np.unique(toks)) > K * lanes // 4


_SEGMENTS = {"flat": lambda S, L: (S * L, 0, 1),
             "rows": lambda S, L: (L, L, 1),
             "cols": lambda S, L: (S, 1, L)}


# the TPU probes' three [8, 128] cases and two other tile shapes
@pytest.mark.parametrize("S,L,segment", [
    (8, 128, "flat"), (8, 128, "rows"), (8, 128, "cols"), (4, 8, "flat"),
    (16, 64, "cols")])
def test_probe_bitonic_schedule_sorts_each_segment(shim, S, L, segment):
    """Every stage of the network touches each place of the tile once (its
    pairs may run in parallel), pairs one segment apart never mix, and the
    whole schedule sorts each segment as the plain version and np.sort."""
    seg = _SEGMENTS[segment](S, L)
    n = S * L
    k = 2
    while k <= seg[0]:
        j = k // 2
        while j >= 1:
            out = np.zeros((n // 2, 3), np.uint32)
            shim.shim_bitonic_stage(n, *seg, k, j, _ptr(out))
            assert sorted(out[:, :2].reshape(-1)) == list(range(n))
            lo, hi = out[:, 0], out[:, 1]
            if segment == "rows":
                assert (lo // L == hi // L).all()
            if segment == "cols":
                assert (lo % L == hi % L).all()
            j //= 2
        k *= 2
    x = np.random.default_rng(n).integers(-2**31, 2**31, (3, S, L)).astype(
        np.int32)
    got = x.copy()
    shim.shim_bitonic(_ptr(got), 3, n, *seg)
    want = PR.bitonic(torch.from_numpy(x), segment).numpy()
    assert (got == want).all()
    ref = (np.sort(x.reshape(3, -1), axis=1).reshape(x.shape)
           if segment == "flat" else np.sort(x, axis=2 if segment == "rows"
                                             else 1))
    assert (want == ref).all()


# ---------------------------------------------------------------------------
# LZ4 / LZ4s block decode (csrc/lz4_block.cuh)
# ---------------------------------------------------------------------------
def _lz4_rows(blocks, n: int | None = None):
    """Blocks zero-padded into uint8[B, n] rows, as decode_blocks lays a
    group out, and their int32 lengths."""
    n = n or LD._next_pow2(max(len(b) for b in blocks) + 8, 1024)
    arr = np.zeros((len(blocks), n), np.uint8)
    lens = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens


def _shim_lz4(shim, arr, lens, outcap: int, lz4s: bool, base: int):
    B, n = arr.shape
    out = np.zeros((B, outcap), np.uint8)
    tot = np.zeros(B, np.int32)
    err = np.zeros(B, np.uint8)
    shim.shim_lz4(_ptr(arr), _ptr(lens), B, n, outcap, int(lz4s), base,
                  _ptr(out), _ptr(tot), _ptr(err))
    return out, tot, err != 0


def _same_rows(a, b) -> np.ndarray:
    """Per row: err equal and, where it is clear, tot and the bytes."""
    (oa, ta, ea), (ob, tb, eb) = a, b
    same = ea == eb
    for r in np.flatnonzero(~ea & ~eb):
        same[r] = ta[r] == tb[r] and np.array_equal(oa[r, :ta[r]],
                                                    ob[r, :tb[r]])
    return same


def _walk(row: np.ndarray, length: int, lz4s: bool, base: int) -> list:
    """The sequences the plain version chains from a row's byte 0, in order:
    (bad, output bytes) of each live one, by its per-byte rules (a length
    extension's 0xFF run counted inside the row and capped, a read past
    the row taking its last byte)."""
    n = len(row)

    def byte(i):
        return int(row[min(i, n - 1)])

    def ext(q):
        q = min(q, n - 1)
        run = 0
        while (q + run < n and row[q + run] == 255
               and run < LD.EXT_RUN_CAP):
            run += 1
        return run + 1, 255 * run + byte(q + run), run >= LD.EXT_RUN_CAP

    seqs, p = [], 0
    while p < length:
        tok = byte(p)
        lit_len, lit_val, lit_ovf = (ext(p + 1) if tok >> 4 == 15
                                     else (0, 0, False))
        q2 = p + 1 + lit_len + (tok >> 4) + lit_val
        term = q2 == length
        off = byte(q2) | byte(q2 + 1) << 8
        m_len, m_val, m_ovf = (ext(q2 + 2) if tok & 15 == 15
                               else (0, 0, False))
        mraw = (tok & 15) + m_val
        mlen = (0 if term else (mraw + base if mraw else 0) if lz4s
                else mraw + 4)
        nxt = length if term else q2 + 2 + m_len
        bad = (lit_ovf or (not term and (m_ovf or off == 0))
               or q2 > length or nxt > length)
        seqs.append((bad, (tok >> 4) + lit_val + mlen))
        p = min(nxt, n)
    return seqs


def _lz4_vs_plain(shim, blocks, lz4s: bool, base: int = 2,
                  outcap: int = LD.MAX_OUT, n: int | None = None,
                  reference: bool = True):
    """The shim on one group against the port's plain version (every row's
    err, and tot and bytes where it is clear), the host decoder (bytes on
    every clear row) and, with ``reference``, the reference's XLA decoder:
    equal on every row but where the reference's two defects (ops/
    lz4_decode.py's docstring) show, a last sequence in error or a
    sequence adding no bytes before it.  Returns the shim's arrays."""
    arr, lens = _lz4_rows(blocks, n)
    n = arr.shape[1]
    got = _shim_lz4(shim, arr, lens, outcap, lz4s, base)
    plain = tuple(t.numpy() for t in LD._decode_blocks_impl(
        torch.from_numpy(arr), torch.from_numpy(lens), n, outcap, lz4s,
        base))
    assert _same_rows(got, plain).all()
    for r, blk in enumerate(blocks):
        if not got[2][r]:
            assert got[0][r, :got[1][r]].tobytes() == LC.host_decode(
                blk, lz4s, base, outcap)
    if reference:
        import jax.numpy as jnp

        ref = tuple(np.asarray(a) for a in RLD._decode_blocks_impl(
            jnp.asarray(arr), jnp.asarray(lens), n, outcap, lz4s, base))
        for r in np.flatnonzero(~_same_rows(got, ref)):
            seqs = _walk(arr[r], int(lens[r]), lz4s, base)
            assert ((seqs[-1][0] and got[2][r] and not ref[2][r])
                    or any(adv == 0 for _, adv in seqs[:-1])), r
    return got


@pytest.mark.parametrize("lz4s", [False, True])
def test_lz4_header_corpus_blocks_match_plain_and_reference(shim,
                                                            corpus_factory,
                                                            lz4s):
    datas = [corpus_factory(s, k) for s, k in
             [(100, "text"), (7000, "text"), (3000, "constant"),
              (2000, "random"), (900, "iterative"), (1, "text")]]
    blocks = [lz4s_block_compress(d, 3) if lz4s else lz4_block_compress(d)
              for d in datas]
    out, tot, err = _lz4_vs_plain(shim, blocks, lz4s)
    assert not err.any()
    assert [out[r, :tot[r]].tobytes() for r in range(len(datas))] == datas


def test_lz4_header_lz4s_blocks_above_64k(shim, corpus_factory):
    """LZ4s blocks of incompressible 64 KB chunks (about 65.8 KB, past the
    reference's MAX_BLOCK but decoded by the port) at the n the group
    takes, 131072."""
    datas = [corpus_factory(1 << 16, "random"),
             corpus_factory(1 << 16, "text")]
    blocks = [lz4s_block_compress(d, 3) for d in datas]
    assert len(blocks[0]) > RLD.MAX_BLOCK
    out, tot, err = _lz4_vs_plain(shim, blocks, True)
    assert not err.any() and out[0, :tot[0]].tobytes() == datas[0]


@pytest.mark.parametrize("lz4s", [False, True])
def test_lz4_header_edge_blocks(shim, corpus_factory, lz4s):
    """Zero offsets, offsets before the start, 0xFF runs at the cap and
    one below, LZ4s zero-length matches, blocks that end after a match or
    are cut short, and overlapping matches at offsets 1-31."""
    names, blocks = zip(*LC.edge_blocks())
    corpus = lz4_block_compress(corpus_factory(6000, "text"))
    cuts = [corpus[:k] for k in (1, 2, 3, 17, len(corpus) // 2,
                                 len(corpus) - 1)]
    out, tot, err = _lz4_vs_plain(shim, list(blocks) + cuts, lz4s)
    flagged = {nm for nm, e in zip(names, err) if e}
    must = {"zero offset", "offset before start", "match run 512",
            "literal run 512", "zero-length match, offset 0",
            "zero-length match, offset 0, last", "truncated offset",
            "truncated match length", "truncated literals",
            "literals past the end"}
    assert must <= flagged
    assert not {"good", "60000-byte run", "match run 511", "literal run 2",
                "ends after a match", "ends after a long match",
                "empty"} & flagged
    # a cut of a corpus block: flagged where the host decoder refuses it
    # (a cut just after a match is a whole block)
    refused = [LC.host_decode(c, lz4s, 2, LD.MAX_OUT) is None for c in cuts]
    assert sum(refused) >= 4
    assert all(e for e, no in zip(err[len(names):], refused) if no)
    row = dict(zip(names, range(len(names))))
    if lz4s:
        assert "zero-length match, far offset" not in flagged
        r = row["zero-length sequence"]
        assert out[r, :tot[r]].tobytes() == b"abcabcz"
    for off in range(1, 32):
        r = row[f"overlap {off}"]
        assert not err[r]
        lit = LC.overlap_literals(off)
        mlen = 15 + LC.OVERLAP_EXT + (2 if lz4s else 4)
        want = (lit * (mlen // off + 2))[:off + mlen] + b"z"
        assert out[r, :tot[r]].tobytes() == want


def test_lz4_header_output_of_exactly_outcap(shim):
    """A block decoding to outcap bytes is clear and one decoding to
    outcap + 1 is flagged, with nothing written past outcap."""
    outcap = 4096
    blocks = [lz4_block_compress(b"A" * outcap),
              lz4_block_compress(b"A" * (outcap + 1)),
              lz4_block_compress(bytes(range(256)) * 16),
              lz4_block_compress(bytes(range(256)) * 16 + b"!")]
    out, tot, err = _lz4_vs_plain(shim, blocks, False, outcap=outcap)
    assert err.tolist() == [False, True, False, True]
    assert tot[0] == tot[2] == outcap


def _lz4_corpus_blocks(lz4s: bool) -> tuple:
    """Eight blocks of 2 KB chunks of the pinned corpus, the fuzz's seeds."""
    from qatzip_tpu_torch.tools.corpus import build_corpus

    corpus = build_corpus(1)
    chunks = [corpus[i * 131_072:i * 131_072 + 2048] for i in range(8)]
    return tuple(lz4s_block_compress(c, 3) if lz4s else lz4_block_compress(c)
                 for c in chunks)


_FUZZ_SEEDS = {lz4s: _lz4_corpus_blocks(lz4s) for lz4s in (False, True)}
_mutation = st.tuples(st.integers(0, 3), st.integers(0, 1 << 16),
                      st.integers(1, 255))


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(lz4s=st.booleans(),
       muts=st.lists(st.lists(_mutation, min_size=1, max_size=4),
                     min_size=8, max_size=8))
def test_lz4_header_fuzzed_corpus_blocks(shim, lz4s, muts):
    """Mutated corpus blocks, a group of 8 an example: the shim equals the
    plain version on every row and the reference on every row its defects
    leave alone, and a clear row's bytes are the host decoder's."""
    blocks = [LC.mutate(b, m) for b, m in zip(_FUZZ_SEEDS[lz4s], muts)]
    _lz4_vs_plain(shim, blocks, lz4s, outcap=8192, n=4096)
