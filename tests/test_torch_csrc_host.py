"""The CUDA kernels' per-record and per-lane logic, built for the host.

``csrc/select.cuh``, ``csrc/inflate_step.cuh``, ``csrc/sort.cuh``,
``csrc/lz4_block.cuh``, ``csrc/chain.cuh``, ``csrc/checksum.cuh`` and
``tools/probes.cuh`` hold the logic of the kernels as ``__host__
__device__`` functions.  g++ builds them here (with
``__host__``/``__device__`` defined away) into a small shim library, and
the shim is held exactly against the port's plain torch versions, or
numpy, on the same inputs; the inflate shim also against the reference's
XLA driver, the LZ4 shim against the reference's XLA decoder and the host
decoder, the checksum shim also against zlib.  The kernels themselves run
only on the card (chip_smoke.py).
"""
import ctypes
import os
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
from qatzip_tpu_torch.ops import chain as CH
from qatzip_tpu_torch.ops import checksums as CK
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
#include "chain.cuh"
#include "checksum.cuh"

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
// own qz_lz4_block: one thread takes both of a CTA's roles, a round's parse
// and then its copy (they touch disjoint shared memory between barriers),
// and each warp's 32 lanes run in turn at each step of the schedule (a
// literal or match step, a ballot over a length extension's bytes, a
// refill), so a lane reads only what the lanes before a __syncwarp wrote.
// The CTA's shared memory starts full of garbage.  The hooks count every
// byte read from the input ring (stats[0]) and from device memory
// (stats[1]) and every window read (stats[3]), and count as faults a byte
// of the input that is not the block's or lies at or past len (stats[2])
// and a window byte that is not the output at its position (stats[4]);
// stats[5] counts the bytes staged.
struct QzHostWarp {
  const uint8_t* row;
  int len;
  const uint8_t* out;
  int64_t* stats;
  static constexpr bool kCheck = true;   // the kernel feeds the hooks
  template <class T>
  struct Reg {   // a value of each lane's own
    T v[QZ_LZ4_LANES];
    T& operator[](int lane) { return v[lane]; }
  };
  template <class F>
  void each(F f) {
    for (int lane = 0; lane < QZ_LZ4_LANES; ++lane) f(lane);
  }
  template <class T>
  T shfl(Reg<T>& r, int src) { return r.v[src]; }
  template <class T>
  void set(Reg<T>& r, int dst, T v) {
    if (dst >= 0 && dst < QZ_LZ4_LANES) r.v[dst] = v;
  }
  void sync() {}
  template <class F>
  uint32_t ballot(F f) {
    uint32_t mask = 0;
    for (int lane = 0; lane < QZ_LZ4_LANES; ++lane)
      if (f(lane)) mask |= 1u << lane;
    return mask;
  }
  void seen_input(int i, int v, bool staged) {
    ++stats[staged ? 0 : 1];
    if (i < 0 || i >= len || v != row[i]) ++stats[2];
  }
  void seen_window(int pos, int v) {
    ++stats[3];
    if (v != out[pos]) ++stats[4];
  }
  void stage(const QzLz4Shm& sm, int off, const uint8_t* src, int bytes) {
    for (int i = 0; i < QZ_LZ4_CHUNK; ++i)
      *sm.host(off + i) = i < bytes ? src[i] : 0;
    stats[5] += bytes;
  }
  void commit() {}
};

// Both roles of a CTA in one thread.  After each barrier but the first it
// notes the round just parsed: its head (round, slot, start, end, count,
// output, final, bad) and its records (round, lit, litlen, off, mlen) as
// the slot holds them, until the last round.
struct QzHostCta {
  QzHostWarp pw, cw;
  QzLz4Smem* sm;
  std::vector<int32_t>* heads;
  std::vector<int32_t>* recs;
  int syncs = 0;
  bool parsed_last = false;
  bool parse() const { return true; }
  bool copy() const { return true; }
  bool lead() const { return true; }
  void landed() {}
  void sync() {
    const int k = syncs++ - 1;
    if (k < 0 || parsed_last || !heads) return;
    const QzLz4Head& h = sm->head[k & 1];
    const int32_t head[8] = {k, k & 1, h.start, h.end, h.count, h.o,
                             h.final, h.bad};
    heads->insert(heads->end(), head, head + 8);
    for (int i = 0; i < h.count; ++i) {
      const QzLz4Rec& r = sm->q[k & 1][i];
      const int32_t rec[5] = {k, r.lit, r.litlen, r.off, r.mlen};
      recs->insert(recs->end(), rec, rec + 5);
    }
    parsed_last = h.final != 0;
  }
};

static void lz4_rows(const uint8_t* in, const int32_t* len, int rows, int n,
                     int outcap, int lz4s, int base, uint8_t* out,
                     int32_t* tot, uint8_t* err, int64_t* stats,
                     std::vector<int32_t>* heads,
                     std::vector<int32_t>* recs) {
  const QzLz4Args a = {in, len, rows, n, outcap, lz4s, base, out, tot, err};
  std::vector<uint8_t> smem(sizeof(QzLz4Smem), 0xA5);
  for (int r = 0; r < rows; ++r) {
    const QzHostWarp w = {in + (int64_t)r * n, len[r],
                          out + (int64_t)r * outcap, stats};
    QzHostCta c = {w, w, (QzLz4Smem*)smem.data(), heads, recs};
    qz_lz4_block(a, r, QzLz4Shm{(uint64_t)(uintptr_t)smem.data()}, c);
  }
}

extern "C" void shim_lz4(const uint8_t* in, const int32_t* len, int rows,
                         int n, int outcap, int lz4s, int base, uint8_t* out,
                         int32_t* tot, uint8_t* err, int64_t* stats) {
  lz4_rows(in, len, rows, n, outcap, lz4s, base, out, tot, err, stats,
           nullptr, nullptr);
}

// One row, with its rounds' heads and records (as QzHostCta notes them)
// into heads[8 x max_heads] and recs[5 x max_recs]; returns the number of
// heads and records in nout[0], nout[1], or -1 where they do not fit.
extern "C" void shim_lz4_trace(const uint8_t* in, int32_t len, int n,
                               int outcap, int lz4s, int base, uint8_t* out,
                               int32_t* tot, uint8_t* err, int64_t* stats,
                               int32_t* heads, int max_heads, int32_t* recs,
                               int max_recs, int32_t* nout) {
  std::vector<int32_t> hs, rs;
  lz4_rows(in, &len, 1, n, outcap, lz4s, base, out, tot, err, stats, &hs,
           &rs);
  const int nh = (int)hs.size() / 8, nr = (int)rs.size() / 5;
  nout[0] = nh <= max_heads ? nh : -1;
  nout[1] = nr <= max_recs ? nr : -1;
  if (nh <= max_heads) std::copy(hs.begin(), hs.end(), heads);
  if (nr <= max_recs) std::copy(rs.begin(), rs.end(), recs);
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

// INDEP<W> at R copies of each table word (0: as qz_probe_indep picks R)
// over [rows, cols] indexes, a [t_rows, w] table, as the kernel runs it: a
// row staged once by a CTA of 128 threads (each staged word stored once,
// or -1), then K steps a lane (lane j & 31) over the staged words
template <int W, int R>
static void shim_indep_row(const uint32_t* row, int w, uint32_t* sm,
                           int* writes) {
  constexpr int V = qzp_indep_v<R>();
  const int n = 128;   // a CTA's threads
  for (int t = 0; t < n; ++t)
    for (int i = t; i < qzp_indep_words(w, W); i += n)
      for (int j = 0; j < R / V; ++j)
        for (int c = 0; c < V; ++c) {
          const int at = qzp_indep_unit_at<R>(i, j, t) + c;
          sm[at] = row[i & (w - 1)] << qzp_indep_shift<R>();
          ++writes[at];
        }
}

template <int W, int R>
static void shim_indep_lanes(const uint32_t* sm, int w, uint32_t* idx,
                             int cols, int K, uint32_t* addrs) {
  constexpr int S = qzp_indep_shift<R>();
  const uint32_t mask = (uint32_t)w - 1u;
  for (int j = 0; j < cols; ++j) {
    uint32_t u = idx[j] << S;
    int n = 0;
    const auto ld = [&](uint32_t a) {
      if (addrs) addrs[j * W + n++ % W] = a;
      return sm[a / 4];
    };
    for (int k = 0; k < K; ++k)
      u = qzp_indep_step<W, R>(4u * (uint32_t)(j & 31 & (R - 1)), u,
                               mask << S, ld);
    idx[j] = (u >> S) & mask;
  }
}

template <int W, int R>
static int shim_indep_r(const uint32_t* t, int t_rows, int w, uint32_t* idx,
                        int rows, int cols, int K, uint32_t* staged,
                        uint32_t* addrs) {
  const int words = qzp_indep_words(w, W) * R;
  std::vector<uint32_t> sm(words);
  for (int r = 0; r < rows; ++r) {
    std::vector<int> writes(words);
    shim_indep_row<W, R>(t + (t_rows == 1 ? 0 : r) * w, w, sm.data(),
                         writes.data());
    for (int c : writes)
      if (c != 1) return -1;
    if (staged && r == 0) std::copy(sm.begin(), sm.end(), staged);
    shim_indep_lanes<W, R>(sm.data(), w, idx + r * cols, cols, K,
                           r == 0 ? addrs : nullptr);
  }
  return R;
}

template <int W>
static int shim_indep_w(int R, const uint32_t* t, int t_rows, int w,
                        uint32_t* idx, int rows, int cols, int K,
                        uint32_t* staged, uint32_t* addrs) {
  int (*f)(const uint32_t*, int, int, uint32_t*, int, int, int, uint32_t*,
           uint32_t*) = R == 32   ? shim_indep_r<W, 32>
                        : R == 16 ? shim_indep_r<W, 16>
                        : R == 8  ? shim_indep_r<W, 8>
                        : R == 4  ? shim_indep_r<W, 4>
                        : R == 2  ? shim_indep_r<W, 2>
                        : R == 1  ? shim_indep_r<W, 1>
                                  : nullptr;
  return f ? f(t, t_rows, w, idx, rows, cols, K, staged, addrs) : -1;
}

// staged: the first row's staged words; addrs: the byte addresses of the
// first row's lanes' loads of their last step ([cols][W]); returns R
extern "C" int shim_indep(int W, int R, const uint32_t* t, int t_rows, int w,
                          uint32_t* idx, int rows, int cols, int K,
                          uint32_t* staged, uint32_t* addrs) {
  if (!R) R = qzp_indep_r(w, W, QZP_MAX_SMEM);
  return W == 4 ? shim_indep_w<4>(R, t, t_rows, w, idx, rows, cols, K, staged,
                                  addrs)
                : shim_indep_w<8>(R, t, t_rows, w, idx, rows, cols, K, staged,
                                  addrs);
}

// The staged word of unit j of thread t's word i, at R copies
extern "C" int shim_indep_unit_at(int R, int i, int j, int t) {
  switch (R) {
    case 32: return qzp_indep_unit_at<32>(i, j, t);
    case 16: return qzp_indep_unit_at<16>(i, j, t);
    case 8: return qzp_indep_unit_at<8>(i, j, t);
    case 4: return qzp_indep_unit_at<4>(i, j, t);
  }
  return -1;
}

// DEP (W 0) or INDEP<W> over [rows, cols] indexes, a [t_rows, w] table
extern "C" void shim_rows(int W, const uint32_t* t, int t_rows, int w,
                          uint32_t* idx, int rows, int cols, int K) {
  if (W) {
    shim_indep(W, 0, t, t_rows, w, idx, rows, cols, K, nullptr, nullptr);
    return;
  }
  for (int r = 0; r < rows; ++r) {
    const uint32_t* row = t + (t_rows == 1 ? 0 : r) * w;
    for (int j = 0; j < cols; ++j) {
      uint32_t v = idx[r * cols + j];
      for (int k = 0; k < K; ++k) v = qzp_dep_step(row, v, w - 1);
      idx[r * cols + j] = v;
    }
  }
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

// The staging of qzp_stage run serially, a thread at a time, through
// recorders: a thread's loads counted (and the most any thread issued
// noted), a load after that thread's first store flagged, a load that
// leaves its block or row flagged, and each word's stores counted.
struct ShimStageLog {
  int loads = 0, most = 0;
  bool storing = false, bad = false;
  std::vector<int> stored;

  void begin() {
    loads = 0;
    storing = false;
  }
  void load() {
    if (storing) bad = true;
    most = std::max(most, ++loads);
  }
};

struct ShimVecStore {
  std::vector<uint32_t>* sm;
  ShimStageLog* log;
  int off;   // the first word item 0 goes to

  void operator()(int i, const uint32_t* v) const {
    log->storing = true;
    const int w = off + 4 * i;
    if (w < 0 || w + 4 > (int)sm->size()) {
      log->bad = true;
      return;
    }
    for (int j = 0; j < 4; ++j) {
      (*sm)[w + j] = v[j];
      ++log->stored[w + j];
    }
  }
};

// a 4-byte shared-memory load of lane `lane` at byte address a: its own
// column of the block only
struct ShimColRead {
  const std::vector<uint32_t>* sm;
  int lane;
  bool* bad;

  uint32_t operator()(uint32_t a) const {
    if (a % 4 || a / 4 >= sm->size() || a / 4 % 32 != (uint32_t)lane) {
      *bad = true;
      return 0;
    }
    return (*sm)[a / 4];
  }
};

// COLUMN as qz_probe_column launches it, serially, a CTA at a time: its
// tensor copies put the block's rows box by box (qzp_col_boxes boxes of
// qzp_col_box rows, box b at word 32 b box; a row past the table reads as
// 0, as the copy fills it) into a shared memory of exactly the boxes'
// words full of garbage, every word written once; then each of its lanes
// (32 x rows, a thread each) walks K steps of qzp_col_step, every load in
// the lane's column.  idx [rows, cols] becomes the output.  info: the rows
// of a box, the boxes, the staged words.  Returns 0, or -1 if a check
// fails.
extern "C" int shim_column_cta(const uint32_t* t, int n, int cols,
                               uint32_t* idx, int rows, int K, uint32_t post,
                               int* info) {
  const int box = qzp_col_box(n), boxes = qzp_col_boxes(n);
  const size_t words = (size_t)boxes * box * 32;
  bool bad = false;
  for (int c0 = 0; c0 < cols; c0 += 32) {
    std::vector<uint32_t> sm(words, 0xA5A5A5A5u);
    std::vector<int> stored(words, 0);
    for (int b = 0; b < boxes; ++b)
      for (int r = 0; r < box; ++r)
        for (int c = 0; c < 32; ++c) {
          const int row = b * box + r;
          const size_t w = (size_t)b * box * 32 + (size_t)r * 32 + c;
          sm[w] = row < n ? t[(size_t)row * cols + c0 + c] : 0u;
          ++stored[w];
        }
    for (int c : stored)
      if (c != 1) return -1;
    for (int th = 0; th < 32 * rows; ++th) {
      const int lane = th % 32;
      uint32_t* at = idx + (size_t)(th / 32) * cols + c0 + lane;
      uint32_t v = *at, w = v << 7;
      for (int k = 0; k < K; ++k)
        qzp_col_step(0u, 4u * (uint32_t)lane, ((uint32_t)n - 1u) << 7, v, w,
                     ShimColRead{&sm, lane, &bad});
      *at = v & post;
    }
  }
  info[0] = box;
  info[1] = boxes;
  info[2] = (int)words;
  return bad ? -1 : 0;
}

// STEP3 and TOKENS' item i: a 16-byte vector of one row of win, tll, td
struct ShimRowLoad {
  const uint32_t* src[3];
  int first;
  ShimStageLog* log;

  void operator()(int i, uint32_t (&v)[4]) const {
    log->load();
    const QzpRowItem it = qzp_row_item(i, first);
    if (it.array < first || it.array > 2 || it.vec < 0 || it.vec >= 32) {
      log->bad = true;
      return;
    }
    for (int j = 0; j < 4; ++j) v[j] = src[it.array][4 * it.vec + j];
  }
};

// One CTA of qz_probe_step's STEP3 (step3) or TOKENS (lone, or the tile)
// staging its row (qzp_row_plan), serially, from one row of each array
// into QZP_TOK_STAGED words of garbage: the words it stages (STEP3 all,
// TOKENS tll's at word 128) stored once and the others not at all, with
// the loads a thread qzp_step is built for (qzp_row_per).  sm receives the
// shared memory; info: the plan's threads and loads a thread, the most
// loads a thread issued.  Returns 0, or -1 if a check fails.
extern "C" int shim_row_stage(int step3, int tile, int lpc,
                              const uint32_t* win, const uint32_t* tll,
                              const uint32_t* td, uint32_t* sm_out,
                              int* info) {
  const QzpStagePlan p = qzp_row_plan(step3 != 0, tile != 0, lpc);
  const int first = step3 ? 0 : 1;
  ShimStageLog log;
  std::vector<uint32_t> sm(QZP_TOK_STAGED, 0xA5A5A5A5u);
  log.stored.assign(sm.size(), 0);
  for (int th = 0; th < p.threads; ++th) {
    log.begin();
    const ShimRowLoad ld = {{win, tll, td}, first, &log};
    const ShimVecStore st = {&sm, &log, 128 * first};
    if (tile)
      qzp_stage<qzp_row_per(true), 4>(th, p.threads,
                                      qzp_row_items(step3 != 0), ld, st);
    else
      qzp_stage<qzp_row_per(false), 4>(th, p.threads,
                                       qzp_row_items(step3 != 0), ld, st);
  }
  for (int w = 0; w < QZP_TOK_STAGED; ++w)
    if (log.stored[w] != (step3 || (w >= 128 && w < 256) ? 1 : 0)) return -1;
  std::copy(sm.begin(), sm.end(), sm_out);
  info[0] = p.threads;
  info[1] = p.per;
  info[2] = log.most;
  return log.bad ? -1 : 0;
}

// STEP5 as qz_probe_step launches it (QzpS5Plan), serially: each CTA's
// THREADS threads in turn run qzp_s5_stage, each its loads (from the host
// columns) and then its stores, into a shared memory of exactly the plan's
// BYTES full of garbage; every word must be stored once.  Then each of the
// CTA's LPC lanes runs K steps of qzp_s5_step, its loads noted a step at a
// time (the 7 loads of a step are 7 instructions of the lane's warp).
// bp advances, the tokens go to toks [K, lanes].  Returns the most
// distinct words one of those instructions reads in one bank (1: no bank
// conflict), or -1 if a load leaves its source or its lane's column, or a
// word is not stored exactly once.
struct ShimS5Load {
  const uint32_t* src[3];
  int rows[3];
  int lanes, l0;
  bool* bad;

  template <int V>
  void operator()(const QzpS5Item& it, uint32_t (&v)[V]) const {
    if (it.row < 0 || it.row >= rows[it.src] || l0 + it.c + V > lanes ||
        it.c % V) {
      *bad = true;
      return;
    }
    for (int j = 0; j < V; ++j)
      v[j] = src[it.src][(size_t)it.row * lanes + l0 + it.c + j];
  }
};

struct ShimS5Store {
  std::vector<uint32_t>* sm;
  std::vector<int>* stores;
  bool* bad;

  template <int V>
  void put(int w, const uint32_t* v) const {
    if (w < 0 || w % V || w + V > (int)sm->size()) {
      *bad = true;
      return;
    }
    for (int j = 0; j < V; ++j) {
      (*sm)[w + j] = v[j];
      ++(*stores)[w + j];
    }
  }
};

struct ShimS5Read {
  const std::vector<uint32_t>* sm;   // byte address a: word a / 4
  std::vector<int>* seen;            // the words a step's loads read
  bool* bad;

  uint32_t operator()(uint32_t a) const {
    if (a % 4 || a / 4 >= sm->size()) {
      *bad = true;
      return 0;
    }
    seen->push_back((int)(a / 4));
    return (*sm)[a / 4];
  }
};

// the most distinct words of one bank among words (a warp's one load)
static int shim_word_ways(const std::vector<int>& words) {
  int most = 0;
  for (int bank = 0; bank < 32; ++bank) {
    std::vector<int> w;
    for (int x : words)
      if (x % 32 == bank && std::find(w.begin(), w.end(), x) == w.end())
        w.push_back(x);
    most = std::max(most, (int)w.size());
  }
  return most;
}

template <class Sh, int LPC>
static int shim_s5_run(const uint32_t* win, const uint32_t* tll,
                       const uint32_t* td, int32_t* bp, uint32_t* toks,
                       int lanes, int K) {
  using P = QzpS5Plan<Sh, LPC>;
  bool bad = false;
  int ways = 1;
  for (int l0 = 0; l0 < lanes; l0 += LPC) {
    std::vector<uint32_t> sm(P::BYTES / 4, 0xA5A5A5A5u);
    std::vector<int> stores(sm.size(), 0);
    const ShimS5Load ld = {{win, tll, td},
                           {Sh::W, Sh::RC + Sh::SC, Sh::RC + Sh::SC},
                           lanes, l0, &bad};
    for (int t = 0; t < P::THREADS; ++t)
      qzp_s5_stage<Sh, LPC>(t, ld, ShimS5Store{&sm, &stores, &bad});
    for (int c : stores)
      if (c != 1) return -1;
    // seen[t][k]: lane t's step k's 7 loads
    std::vector<std::vector<std::vector<int>>> seen(
        LPC, std::vector<std::vector<int>>(K));
    for (int t = 0; t < LPC; ++t)
      for (int k = 0; k < K; ++k) {
        toks[(size_t)k * lanes + l0 + t] = qzp_s5_step<Sh, LPC>(
            0u, 4u * (uint32_t)t, bp[l0 + t],
            ShimS5Read{&sm, &seen[t][k], &bad});
        for (int w : seen[t][k])
          if (w % LPC != t) bad = true;   // a lane reads its column only
      }
    for (int k = 0; k < K; ++k)
      for (int j = 0; j < 7; ++j) {
        std::vector<int> words;
        for (int t = 0; t < LPC; ++t) {
          if (seen[t][k].size() != 7) return -1;
          words.push_back(seen[t][k][j]);
        }
        ways = std::max(ways, shim_word_ways(words));
      }
  }
  return bad ? -1 : ways;
}

extern "C" int shim_step5(const uint32_t* win, const uint32_t* tll,
                          const uint32_t* td, int32_t* bp, uint32_t* toks,
                          int lanes, int K, int W, int rc, int sc, int lpc) {
  return qzp_s5_dispatch(W, rc, sc, lpc, [&](auto sh, auto l) {
    return shim_s5_run<decltype(sh), decltype(l)::value>(win, tll, td, bp,
                                                         toks, lanes, K);
  });
}

// QzpS5Plan at a shape and lanes a CTA: threads, vec, per, bytes, items
// (-1s for one the kernels are not built for)
extern "C" void shim_s5_plan(int rc, int lpc, int* out) {
  for (int i = 0; i < 5; ++i) out[i] = -1;
  qzp_s5_dispatch(128, rc, 256, lpc, [&](auto sh, auto l) {
    using P = QzpS5Plan<decltype(sh), decltype(l)::value>;
    const int f[5] = {P::THREADS, P::VEC, P::PER, P::BYTES, P::ITEMS};
    for (int i = 0; i < 5; ++i) out[i] = f[i];
    return 0;
  });
}

// The widened entries against the u16 ones, a half h[i] at a time over the
// stream bits b0[i], b1[i] (root index bits rbits): out[9 * i + ...] gets
// 0: h as a root is a pointer (bit 31 clear); 1: the low 9 bits of its
// subtable index over b0 as qzp_s5_resolve sums it from the root word
// widened for every row width (shifts 1-6; 0xFFFFFFFF where two differ);
// for h as a final litlen entry reached through a
// subtable cell (half 0 and half 1 agree, else 0xFFFFFFFF) with hd[i] as
// the distance entry (likewise), 2: the match length, 3: bits2 (b0, b1
// shifted by used1), 4: dist1, 5: adv, 6: tok & 1; 7, 8: a non-pointer
// root's match length and adv (0 for a pointer).
extern "C" void shim_s5_entries(const uint32_t* h, const uint32_t* hd,
                                const uint32_t* b0, const uint32_t* b1,
                                int n, int rbits, uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    uint32_t* o = out + 9 * (size_t)i;
    const uint32_t L = qzp_s5_lit16(h[i]), D = qzp_s5_dist16(hd[i]);
    const uint32_t r = qzp_s5_root(h[i], L, 1), rd = qzp_s5_root(hd[i], D, 1);
    o[0] = (int32_t)r >= 0;
    for (uint32_t sh = 1; sh <= 6; ++sh) {
      const uint32_t w = qzp_s5_root(h[i], L, sh);
      const uint32_t s =
          (((w >> 16) + ((b0[i] >> (rbits - sh)) & w)) >> sh) & 0x1FFu;
      o[1] = sh == 1 || o[1] == s ? s : 0xFFFFFFFFu;
    }
    uint32_t got[2][5];
    for (int half = 0; half < 2; ++half) {
      const uint32_t junk = 0x5A5Au;
      const uint32_t e =
          qzp_s5_cell(half ? (h[i] << 16) | junk : (junk << 16) | h[i], true) >>
          (16 * half);
      const uint32_t ed =
          qzp_s5_cell(half ? (hd[i] << 16) | junk : (junk << 16) | hd[i],
                      false) >>
          (16 * half);
      const uint32_t bits2 = qzp_funnel(b0[i], b1[i], e);
      const uint32_t mlen = qzp_s5_mlen(e, b0[i]);
      const uint32_t dist1 = qzp_s5_dist1(ed, bits2);
      const uint32_t tok = 2u | (mlen << 2) | (dist1 << 11);
      const uint32_t g[5] = {mlen, bits2, dist1, qzp_s5_adv(e, ed), tok & 1u};
      for (int j = 0; j < 5; ++j) got[half][j] = g[j];
    }
    for (int j = 0; j < 5; ++j)
      o[2 + j] = got[0][j] == got[1][j] ? got[0][j] : 0xFFFFFFFFu;
    const bool ptr = (int32_t)r >= 0, dptr = (int32_t)rd >= 0;
    o[7] = ptr ? 0u : qzp_s5_mlen(r, b0[i]);
    o[8] = ptr || dptr ? 0u : qzp_s5_adv(r, rd);
  }
}

// TOKENS' tile as qz_probe_step runs it, serially, a CTA of lpc lanes at a
// time: for each buffer's rows steps, every thread's steps (qzp_tok_step)
// into the buffer qzp_tok_buffer names; then the flush: thread 0's wait
// for its copy in flight (which copies the buffer as it is now: -1 if a
// step wrote it after the copy was issued), the barrier, then thread 0's
// copy of the whole buffer issued as one group.  At the end thread 0
// waits.  A version a buffer word counts its stores, so that a step that
// rewrites a row under a copy shows even where it stores the same token.
// t [lanes / 128, 128], idx [lanes], toks [K, lanes].  Returns the rows of
// a buffer, or -1.
struct ShimTokCopy {
  int buf, k0;
  std::vector<int> versions;
};

extern "C" int shim_tokens_tile(const uint32_t* t, const int32_t* idx,
                                uint32_t* toks, int lanes, int lpc, int tile,
                                int K) {
  const int rows = qzp_tok_rows(tile, lpc);
  if (rows < 1 || rows > 256 || K % tile ||
      (QZP_TOK_STAGED + 2 * rows * lpc) * 4 > QZP_MAX_SMEM)
    return -1;
  const size_t words = (size_t)rows * lpc;   // a buffer
  for (int l0 = 0; l0 < lanes; l0 += lpc) {
    const uint32_t* tbl = t + (size_t)(l0 >> 7) * 128;
    std::vector<uint32_t> buf(2 * words, 0xA5A5A5A5u);
    std::vector<int> ver(buf.size(), 0);
    std::vector<int32_t> s(idx + l0, idx + l0 + lpc);
    std::vector<ShimTokCopy> pending;   // thread 0's
    auto complete = [&]() {
      for (const ShimTokCopy& c : pending)
        for (size_t w = 0; w < words; ++w) {
          if (ver[c.buf * words + w] != c.versions[w]) return false;
          toks[(size_t)(c.k0 + w / lpc) * lanes + l0 + w % lpc] =
              buf[c.buf * words + w];
        }
      pending.clear();
      return true;
    };
    for (int k0 = 0; k0 < K; k0 += rows) {
      const int b = qzp_tok_buffer(k0, rows);
      for (int th = 0; th < lpc; ++th)
        for (int kt = 0; kt < rows; ++kt) {
          if (qzp_tok_buffer(k0 + kt, rows) != b) return -1;
          const size_t w = b * words + (size_t)kt * lpc + th;
          buf[w] = qzp_tok_step(tbl, s[th]);
          ++ver[w];
        }
      if (!complete()) return -1;
      pending.push_back({b, k0, std::vector<int>(ver.begin() + b * words,
                                                 ver.begin() + (b + 1) * words)});
    }
    if (!complete()) return -1;
  }
  return rows;
}

// BITONIC as qz_probe_tile places it (qzp_bit_plan), run serially, a
// stage at a time over every slot: a slot's partner values are taken from
// the slots' values before the stage, as a warp's shuffle or the
// shared-memory exchange hands them over.
template <int V>
static void shim_bit_stage(std::vector<int32_t>& x, const QzpBitPlan& p,
                           int k, int j) {
  const std::vector<int32_t> old = x;
  for (int q = 0; q < p.slots; ++q) {
    int32_t* v = &x[q * V];
    const int t = q % p.t;
    if (qzp_bit_where(j, V) == QZP_BIT_REGS) {
      qzp_bit_regs<V>(v, t, k, j);
      continue;
    }
    const bool lo = qzp_bit_keeps_min(t, V, k, j);
    for (int e = 0; e < V; ++e)
      v[e] = qzp_bit_pick(old[q * V + e], old[(q ^ (j / V)) * V + e], lo);
  }
}

extern "C" void shim_bitonic(int32_t* x, int tiles, int n, int seg_n,
                             int seg_stride, int elem_stride) {
  const QzpBitPlan p = qzp_bit_plan(n, seg_n);
  for (int tl = 0; tl < tiles; ++tl) {
    int32_t* tile = x + tl * n;
    std::vector<int32_t> v(n);
    for (int q = 0; q < p.slots; ++q)
      for (int e = 0; e < p.v; ++e)
        v[q * p.v + e] = tile[qzp_bit_place(p, q, e, seg_stride, elem_stride)];
    for (int k = 2; k <= seg_n; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) switch (p.v) {
          case 1: shim_bit_stage<1>(v, p, k, j); break;
          case 2: shim_bit_stage<2>(v, p, k, j); break;
          case 4: shim_bit_stage<4>(v, p, k, j); break;
          case 8: shim_bit_stage<8>(v, p, k, j); break;
        }
    for (int q = 0; q < p.slots; ++q)
      for (int e = 0; e < p.v; ++e)
        tile[qzp_bit_place(p, q, e, seg_stride, elem_stride)] = v[q * p.v + e];
  }
}

// Stage (k, j) of one tile: for value e of slot q, row q V + e of out is
// its place, its partner's place, where the two meet (QZP_BIT_REGS, SHFL,
// SMEM) and the partner's slot; plan: v, t, slots, threads
extern "C" void shim_bitonic_stage(int n, int seg_n, int seg_stride,
                                   int elem_stride, int k, int j, int* out,
                                   int* plan) {
  const QzpBitPlan p = qzp_bit_plan(n, seg_n);
  plan[0] = p.v;
  plan[1] = p.t;
  plan[2] = p.slots;
  plan[3] = p.threads;
  const int where = qzp_bit_where(j, p.v);
  for (int q = 0; q < p.slots; ++q)
    for (int e = 0; e < p.v; ++e) {
      const int q2 = where == QZP_BIT_REGS ? q : q ^ (j / p.v);
      const int e2 = where == QZP_BIT_REGS ? e ^ j : e;
      int* o = out + 4 * (q * p.v + e);
      o[0] = qzp_bit_place(p, q, e, seg_stride, elem_stride);
      o[1] = qzp_bit_place(p, q2, e2, seg_stride, elem_stride);
      o[2] = where;
      o[3] = q2;
    }
}

// BITONIC over a row of 65536 as qz_probe_bitonic_row places it (the
// qzp_row_* plan, QZP_ROW_V values a thread, at clusters of ctas CTAs: the
// kernel's 16, or 8 to check the plan at another size), run serially: each
// CTA of the row's cluster a host array of its threads' registers, a pass
// at a time over every CTA and thread, a
// thread's partner values (its own, a lane's by shuffle, another warp's
// through shared memory, or the same thread's of another CTA through its
// receive buffer) taken from the values before the pass.  plan, if not
// null: 8 ints a pass of the network, in order: k, j, where the pair meets,
// the partner's slot in the CTA (j / V a lane or a warp away; the thread
// itself in registers or across CTAs), the partner CTA's rank for CTA 0,
// the pass's number among the passes across CTAs, its buffer and the
// parity it waits for in the second sort (-1 where the pass stays in the
// CTA).
static void shim_row(int32_t* row, int ctas, int* plan) {
  constexpr int V = QZP_ROW_V;
  const int n = QZP_ROW_N / ctas, T = n / V, ln = qzp_lg(n);
  const int lc = QZP_ROW_LG - ln, nb = qzp_row_buffers(lc);
  std::vector<int32_t> v(row, row + QZP_ROW_N);   // slot t's values at t V
  int i = 0;
  for (int k = 2; k <= QZP_ROW_N; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1, ++i) {
      const int where = qzp_row_where(j, V, n);
      const bool cross = where == QZP_BIT_CLUSTER;
      const int p = cross ? qzp_row_pass(qzp_lg(k), qzp_lg(j), ln) : -1;
      if (plan) {
        int* o = plan + 8 * i;
        o[0] = k;
        o[1] = j;
        o[2] = where;
        o[3] = where == QZP_BIT_REGS || cross ? 0 : j / V;
        o[4] = cross ? qzp_row_partner(0, j, n) : 0;
        o[5] = p;
        o[6] = cross ? p % nb : -1;
        o[7] = cross ? (int)qzp_row_parity(lc, p, 1) : -1;
      }
      const std::vector<int32_t> old = v;
      for (int r = 0; r < ctas; ++r)
        for (int h = 0; h < T; ++h) {
          const int t = r * T + h;
          int32_t* x = &v[(size_t)t * V];
          if (where == QZP_BIT_REGS) {
            qzp_bit_regs<V>(x, t, k, j);
            continue;
          }
          const int src = cross ? qzp_row_partner(r, j, n) * T + h
                                : r * T + (h ^ (j / V));
          const bool lo = qzp_bit_keeps_min(t, V, k, j);
          for (int e = 0; e < V; ++e)
            x[e] = qzp_bit_pick(old[(size_t)t * V + e],
                                old[(size_t)src * V + e], lo);
        }
    }
  std::copy(v.begin(), v.end(), row);
}

extern "C" void shim_bitonic_row(int32_t* x, int rows, int ctas,
                                 int* plan) {
  for (int b = 0; b < rows; ++b) {
    int32_t* row = x + (size_t)b * QZP_ROW_N;
    shim_row(row, ctas, b == 0 ? plan : nullptr);
  }
}

// ROLL on the row axis as qz_probe_roll launches it, run serially: every
// (CTA, threadIdx.y, threadIdx.x) of qzp_roll_rows_plan copies its vec
// words from the row qzp_roll_src_row names; writes counts the stores to
// each output word.  Returns the CTAs, or -1 for a CTA past 256 threads.
extern "C" int shim_roll_rows(const uint32_t* x, uint32_t* out, int* writes,
                              int rows, int cols, int shift, int vec) {
  const QzpRollPlan p = qzp_roll_rows_plan(rows, cols, vec);
  if (p.vpr * p.rpc > 256 || p.vpr * vec != cols) return -1;
  for (int b = 0; b < p.blocks; ++b)
    for (int y = 0; y < p.rpc; ++y)
      for (int t = 0; t < p.vpr; ++t) {
        const int r = b * p.rpc + y;
        if (r >= rows) continue;
        const int src = qzp_roll_src_row(r, shift, rows);
        for (int e = 0; e < vec; ++e) {
          out[r * cols + t * vec + e] = x[src * cols + t * vec + e];
          ++writes[r * cols + t * vec + e];
        }
      }
  return p.blocks;
}

// ROLL on the lane axis: each warp's 32 threads hold 4 words of their row,
// and output word 4t + j is the word of the lane qzp_roll_lane_src names,
// as __shfl_sync delivers it.  Returns the warps a CTA.
extern "C" int shim_roll_lanes(const uint32_t* x, uint32_t* out, int rows,
                               int shift) {
  for (int r = 0; r < rows; ++r)
    for (int t = 0; t < 32; ++t)
      for (int j = 0; j < 4; ++j) {
        const QzpLaneSrc src = qzp_roll_lane_src(t, j, shift);
        out[r * 128 + 4 * t + j] = x[r * 128 + 4 * src.lane + src.word];
      }
  return qzp_roll_lanes_warps(rows);
}

// REFILL as qz_probe_refill runs it, a lane at a time: K refills into a
// shared memory of win + 8 words full of garbage, by words (vec 0: the LD
// kernel on rows that are not 16-byte aligned) or by the 16-byte vectors of
// the window's span (vec 1: LD, CP and TMA), a warp's 32 threads in turn;
// then the window out.  Returns -1 if a read leaves the lane's row or a
// store leaves the shared memory.
extern "C" int shim_refill(const uint32_t* x, uint32_t* out,
                           const int32_t* off, int rows, int cols, int alt,
                           int win, int K, int vec) {
  std::vector<uint32_t> sm(win + 8);
  for (int b = 0; b < rows; ++b) {
    std::fill(sm.begin(), sm.end(), 0xA5A5A5A5u);
    const uint32_t* row = x + (size_t)b * cols;
    int head = 0;
    for (int k = 0; k < K; ++k) {
      const int o = qzp_refill_at(off[b], k, alt);
      if (!vec) {
        for (int t = 0; t < 32; ++t)
          for (int w = t; w < win; w += 32) {
            if (o + w < 0 || o + w >= cols) return -1;
            sm[w] = row[o + w];
          }
        continue;
      }
      const QzpSpan sp = qzp_refill_span(o, win);
      head = sp.head;
      if (sp.base < 0 || sp.base % 4 || sp.base + 4 * sp.nvec > cols ||
          4 * sp.nvec > win + 8)
        return -1;
      for (int t = 0; t < 32; ++t)
        for (int v = t; v < sp.nvec; v += 32)
          for (int e = 0; e < 4; ++e)
            sm[4 * v + e] = row[sp.base + 4 * v + e];
    }
    for (int w = 0; w < win; ++w) out[(size_t)b * win + w] = sm[head + w];
  }
  return 0;
}

// TRANSPOSE as qz_probe_transpose runs it, serially: each CTA of the
// cluster (qzp_tr_plan) loads its block into buffer 0 of its own shared
// memory (two buffers full of garbage, then 8 guard words), then each step
// runs one CTA at a time, its threads in turn, through qzp_tr_gather into
// its partner's other buffer; then the blocks out.  Returns the CTAs, or
// -1 if a step changed a buffer that the step reads or a guard word, or an
// output word was not stored exactly once.
extern "C" int shim_transpose(const uint32_t* x, uint32_t* out, int n,
                              int K) {
  const QzpTrPlan p = qzp_tr_plan(n);
  const int words = p.b * p.stride, per = 2 * words + 8;
  std::vector<uint32_t> sm((size_t)p.ctas * per, 0xA5A5A5A5u);
  std::vector<int> writes((size_t)n * n, 0);
  for (int q = 0; q < p.ctas; ++q)
    for (int t = 0; t < p.threads; ++t)
      for (int i = t; i * 4 < p.b * p.b; i += p.threads) {
        const int r = i * 4 / p.b, c = i * 4 % p.b;
        for (int e = 0; e < 4; ++e)
          sm[q * per + r * p.stride + c + e] =
              x[qzp_tr_global(p, n, q, r, c) + e];
      }
  int cur = 0;
  for (int k = 0; k < K; ++k) {
    const std::vector<uint32_t> before(sm);
    for (int q = 0; q < p.ctas; ++q) {
      const uint32_t* src = sm.data() + q * per + cur * words;
      uint32_t* dst =
          sm.data() + qzp_tr_partner(q, p.nb) * per + (cur ^ 1) * words;
      for (int t = 0; t < p.threads; ++t) {
        uint32_t v[4];
        const int o = qzp_tr_gather(p, t, src, v);
        if (o >= 0)
          for (int e = 0; e < 4; ++e) dst[o + e] = v[e];
      }
    }
    for (int q = 0; q < p.ctas; ++q) {
      for (int w = 0; w < words; ++w)
        if (sm[q * per + cur * words + w] != before[q * per + cur * words + w])
          return -1;
      for (int w = 2 * words; w < per; ++w)
        if (sm[q * per + w] != 0xA5A5A5A5u) return -1;
    }
    cur ^= 1;
  }
  for (int q = 0; q < p.ctas; ++q)
    for (int t = 0; t < p.threads; ++t)
      for (int i = t; i * 4 < p.b * p.b; i += p.threads) {
        const int r = i * 4 / p.b, c = i * 4 % p.b;
        for (int e = 0; e < 4; ++e) {
          const int g = qzp_tr_global(p, n, q, r, c) + e;
          out[g] = sm[q * per + cur * words + r * p.stride + c + e];
          ++writes[g];
        }
      }
  for (int w : writes)
    if (w != 1) return -1;
  return p.ctas;
}

// qzp_tr_plan's fields: b, nb, ctas, stride, threads
extern "C" void shim_tr_plan(int n, int* out) {
  const QzpTrPlan p = qzp_tr_plan(n);
  const int f[5] = {p.b, p.nb, p.ctas, p.stride, p.threads};
  for (int i = 0; i < 5; ++i) out[i] = f[i];
}

// The shared-memory words thread t of a step reads (src, its own buffer)
// and writes (dst, the partner's), from qzp_tr_gather over a source
// buffer holding its own offsets; returns the words written.
extern "C" int shim_tr_thread(int n, int t, int* src_off, int* dst_off) {
  const QzpTrPlan p = qzp_tr_plan(n);
  std::vector<uint32_t> src(p.b * p.stride);
  for (size_t w = 0; w < src.size(); ++w) src[w] = (uint32_t)w;
  uint32_t v[4];
  const int o = qzp_tr_gather(p, t, src.data(), v);
  if (o < 0) return 0;
  for (int e = 0; e < 4; ++e) {
    dst_off[e] = o + e;
    src_off[e] = (int)v[e] - 1;
  }
  return 4;
}

// qzp_dep_stage's sink in the shim: each CTA of a cluster's shared memory
// a host array; counts the stores to each word of each.
struct ShimDepSink {
  std::vector<std::vector<uint32_t>>* sm;
  std::vector<std::vector<int>>* stores;

  void word(int c, uint32_t a) const {
    for (size_t d = 0; d < sm->size(); ++d) {
      (*sm)[d][c] = a;
      ++(*stores)[d][c];
    }
  }
  void vec(int v, uint32_t a, uint32_t b, uint32_t c, uint32_t e) const {
    const uint32_t x[4] = {a, b, c, e};
    for (int i = 0; i < 4; ++i) word(4 * v + i, x[i]);
  }
};

// DEP as qz_probe_dep launches it (qzp_dep_plan), serially: each cluster
// of gx CTAs (a row of them) stages its table row through qzp_dep_stage,
// every thread of every CTA in turn, into the CTAs' shared memories (w
// words each, full of garbage), then each thread of each CTA runs its
// chain in its own; writes counts the stores to each output word, plan
// gets tx, ty, gx, gy.  Returns the table rows staged (one a cluster), or
// -1 for a CTA past QZP_DEP_THREADS threads (unless its row is wider than
// a cluster of them), a cluster past QZP_DEP_CLUSTER CTAs, or a word of a
// CTA's shared memory not stored exactly once.
extern "C" int shim_dep(const uint32_t* t, int t_rows, int w,
                        const uint32_t* idx, uint32_t* out, int* writes,
                        int rows, int cols, int K, int vec, int* plan) {
  const QzpDepPlan p = qzp_dep_plan(rows, cols, t_rows);
  const int f[4] = {p.tx, p.ty, p.gx, p.gy};
  for (int i = 0; i < 4; ++i) plan[i] = f[i];
  const int n = p.tx * p.ty;
  if ((n > QZP_DEP_THREADS && cols <= QZP_DEP_CLUSTER * QZP_DEP_THREADS) ||
      n > 1024 || p.gx > QZP_DEP_CLUSTER)
    return -1;
  int staged = 0;
  for (int by = 0; by < p.gy; ++by) {
    std::vector<std::vector<uint32_t>> sm(p.gx,
                                          std::vector<uint32_t>(w, 0xA5A5A5A5u));
    std::vector<std::vector<int>> stores(p.gx, std::vector<int>(w, 0));
    const uint32_t* row = t + (t_rows == 1 ? 0 : (size_t)by * w);
    for (int rank = 0; rank < p.gx; ++rank)
      for (int tid = 0; tid < n; ++tid)
        qzp_dep_stage(row, w, vec != 0, rank * n + tid, p.gx * n,
                      ShimDepSink{&sm, &stores});
    ++staged;
    for (const auto& s : stores)
      for (int c : s)
        if (c != 1) return -1;
    for (int bx = 0; bx < p.gx; ++bx)
      for (int y = 0; y < p.ty; ++y)
        for (int x = 0; x < p.tx; ++x) {
          const int r = by * p.ty + y, j = bx * p.tx + x;
          if (r >= rows || j >= cols) continue;
          uint32_t v = idx[(size_t)r * cols + j];
          for (int k = 0; k < K; ++k)
            v = qzp_dep_step(sm[bx].data(), v, (uint32_t)w - 1u);
          out[(size_t)r * cols + j] = v;
          ++writes[(size_t)r * cols + j];
        }
  }
  return staged;
}

// The row path's three launches of csrc/chain.cu run serially through
// chain.cuh's own functions: phase A a warp at a time (its lanes stage
// their words into a shared memory full of garbage, then find their exits,
// then store them), phase B a row at a time, phase C a warp at a time
// (every lane walks 32 steps into a tile full of garbage, then every lane
// stores its column).  out int32 [rows, n], ent int32 [rows, n / seg].
extern "C" void shim_chain(const int32_t* f, int32_t* out, int32_t* ent,
                           int rows, int n, int seg) {
  int seg_lg = 0;
  while ((1 << seg_lg) < seg) ++seg_lg;
  const QzChainArgs a = {f, out, ent, rows, n, seg, seg_lg};
  const int64_t G = qz_chain_segments(a);
  const int nseg = n >> seg_lg;
  std::vector<int32_t> sm(QZ_CHAIN_LANES * (seg + 1));
  std::vector<int32_t> tile(QZ_CHAIN_LANES * QZ_CHAIN_TILE);
  for (int64_t g0 = 0; g0 < G; g0 += QZ_CHAIN_LANES) {
    const int nact = (int)std::min<int64_t>(QZ_CHAIN_LANES, G - g0);
    const int words = nact << seg_lg;
    for (int32_t& w : sm) w = (int32_t)0xA5A5A5A5u;
    for (int lane = 0; lane < QZ_CHAIN_LANES; ++lane)
      qz_chain_stage(f + (g0 << seg_lg), sm.data(), words, seg_lg, lane);
    for (int lane = 0; lane < nact; ++lane)
      qz_chain_exits(sm.data() + lane * (seg + 1),
                     (int)((g0 + lane) % nseg) << seg_lg, seg);
    for (int lane = 0; lane < QZ_CHAIN_LANES; ++lane)
      qz_chain_unstage(sm.data(), out + (g0 << seg_lg), words, seg_lg, lane);
  }
  for (int row = 0; row < rows; ++row)
    qz_chain_entries(out + (int64_t)row * n, ent + (int64_t)row * nseg, n,
                     seg);
  for (int64_t g0 = 0; g0 < G; g0 += QZ_CHAIN_LANES) {
    const int nact = (int)std::min<int64_t>(QZ_CHAIN_LANES, G - g0);
    int32_t p[QZ_CHAIN_LANES];
    for (int lane = 0; lane < nact; ++lane) p[lane] = ent[g0 + lane];
    for (int k0 = 0; k0 < seg; k0 += QZ_CHAIN_LANES) {
      for (int32_t& w : tile) w = (int32_t)0xA5A5A5A5u;
      for (int lane = 0; lane < nact; ++lane) {
        const int64_t g = g0 + lane;
        p[lane] = qz_chain_walk32(f + (g / nseg) * n, p[lane],
                                  (int)(g % nseg + 1) << seg_lg,
                                  tile.data() + lane * QZ_CHAIN_TILE);
      }
      for (int lane = 0; lane < QZ_CHAIN_LANES; ++lane)
        qz_chain_flush(tile.data(), out, g0, nact, seg, k0, lane);
    }
  }
}

// qz_chain_plan for a share of `share` words: info[0] CTAs a cluster (0:
// the row path), [1] segments a CTA, [2] threads a segment in phase A, [3]
// shared bytes.
extern "C" void shim_chain_plan(int n, int seg, int share, int* info) {
  const QzChainPlan pl = qz_chain_plan(n, seg, share);
  info[0] = pl.c;
  info[1] = pl.spc;
  info[2] = pl.parts;
  info[3] = pl.smem;
}

// The cluster path's launch of csrc/chain.cu run serially, a row's cluster
// at a time, each CTA's shared memory a vector of exactly its plan's bytes
// full of garbage, in qz_chain_cluster_kernel's order: every CTA's threads
// stage its share (in thread order), every segment's parts find their
// exits, then the doubling rounds (each thread in order, a round at a
// time); then the CTAs' thread 0 walk their shares from their first positions (the guesses),
// and then, in rank order, from the entry the CTA before handed over (the
// handoff word) until the walks meet; then each CTA restages its share and
// its warps walk and store.  share: words a CTA at most (QZ_CHAIN_SHARE on
// the card; less cuts small rows into many CTAs).  met[row * c + rank]
// gets the segments the CTA's second walk took before it met the first
// (cnt where it never did).  Returns the CTAs a cluster, 0 (nothing run)
// where the plan takes the row path.
extern "C" int shim_chain_cluster(const int32_t* f, int32_t* out, int rows,
                                  int n, int seg, int share, int32_t* met) {
  int seg_lg = 0;
  while ((1 << seg_lg) < seg) ++seg_lg;
  const QzChainPlan pl = qz_chain_plan(n, seg, share);
  if (pl.c == 0) return 0;
  const QzChainSmem m = qz_chain_smem(pl, seg);
  const int nseg = n >> seg_lg;
  for (int row = 0; row < rows; ++row) {
    std::vector<std::vector<uint32_t>> sm(pl.c);
    std::vector<int> s0(pl.c), cnt(pl.c);
    std::vector<int32_t> spec(pl.c);
    for (int r = 0; r < pl.c; ++r) {
      sm[r].assign(pl.smem / sizeof(uint32_t), 0xA5A5A5A5u);
      s0[r] = qz_chain_share(pl, nseg, r, &cnt[r]);
      sm[r][m.handoff] = (uint32_t)-1;
      const uint32_t first = (uint32_t)s0[r] << seg_lg;
      for (int t = 0; t < QZ_CHAIN_THREADS; ++t)
        qz_chain_stage4(f + (int64_t)row * n + first, sm[r].data(),
                         cnt[r] << seg_lg, seg_lg, first, t, QZ_CHAIN_THREADS);
      for (int round = 0; round == 0 || (1 << (round - 1)) < pl.parts;
           ++round)
        for (int t = 0; t < QZ_CHAIN_THREADS; ++t) {
          const int sl = t % pl.spc, q = t / pl.spc;
          if (sl >= cnt[r] || q >= pl.parts) continue;
          uint32_t* s = sm[r].data() + sl * (seg + 1);
          if (round == 0)
            qz_chain_exits_part(s, seg, pl.parts, q);
          else
            qz_chain_exits_double(s, seg, pl.parts, q);
        }
      int32_t* ent = (int32_t*)(sm[r].data() + m.ent);
      spec[r] = qz_chain_share_entries(sm[r].data(), ent, (int32_t)first,
                                       s0[r], cnt[r], seg_lg);
    }
    int32_t e = 0;
    for (int r = 0; r < pl.c; ++r) {
      if (r > 0) e = (int32_t)sm[r][m.handoff];
      int32_t* ent = (int32_t*)(sm[r].data() + m.ent);
      // the segments before the walks meet: the first whose guessed entry
      // equals the true one
      std::vector<int32_t> guess(ent, ent + cnt[r]);
      e = qz_chain_share_verify(sm[r].data(), ent, e, s0[r], cnt[r], seg_lg,
                                spec[r]);
      int took = 0;
      while (took < cnt[r] && guess[took] != ent[took]) ++took;
      met[row * pl.c + r] = took;
      if (r + 1 < pl.c) sm[r + 1][m.handoff] = (uint32_t)e;
    }
    for (int r = 0; r < pl.c; ++r) {
      const uint32_t first = (uint32_t)s0[r] << seg_lg;
      const int64_t base = (int64_t)row * n + first;
      const int32_t* ent = (const int32_t*)(sm[r].data() + m.ent);
      for (int t = 0; t < QZ_CHAIN_THREADS; ++t)
        qz_chain_stage4(f + base, sm[r].data(), cnt[r] << seg_lg, seg_lg,
                         first, t, QZ_CHAIN_THREADS);
      for (int g = 0; g < cnt[r]; g += QZ_CHAIN_LANES) {
        const int nact = std::min(QZ_CHAIN_LANES, cnt[r] - g);
        int32_t* tile = (int32_t*)(sm[r].data() + m.tile) +
                        g * QZ_CHAIN_TILE;
        uint32_t off[QZ_CHAIN_LANES];
        for (int lane = 0; lane < nact; ++lane)
          off[lane] = (uint32_t)ent[g + lane] -
                      (first + ((uint32_t)(g + lane) << seg_lg));
        for (int k0 = 0; k0 < seg; k0 += QZ_CHAIN_LANES) {
          for (int lane = 0; lane < nact; ++lane) {
            const int sw = g + lane;
            off[lane] = qz_chain_walk32_local(
                sm[r].data() + sw * (seg + 1),
                first + ((uint32_t)sw << seg_lg), off[lane], seg,
                tile + lane * QZ_CHAIN_TILE);
          }
          for (int lane = 0; lane < QZ_CHAIN_LANES; ++lane)
            qz_chain_flush(tile, out + base, g, nact, seg, k0, lane);
        }
      }
    }
  }
  return pl.c;
}

// qz_ck_plan (p 0) or qz_ck_plan_p: info[0] CTAs a row, [1] log2 of a
// slice's bytes, [2] log2 of the bytes the slices span.
extern "C" void shim_checksum_plan(int rows, int n, int p, int* info) {
  const QzCkPlan pl = p ? qz_ck_plan_p(p, n) : qz_ck_plan(rows, n);
  info[0] = pl.p;
  info[1] = pl.s_lg;
  info[2] = pl.n_lg;
}

// checksum.cu's qz_ck_warp_join over lanes [0, n_in) of v (CRC32
// registers), as the shuffles run it: at each level lane l joins the value
// lane l + 2^j held before the level (lanes in increasing order update in
// place; a lane past n_in keeps its own value).
static void shim_crc_tree(const uint32_t* zadv, int k0, int n_in,
                          std::vector<uint32_t>& v) {
  for (int l = 0; (1 << l) < n_in; ++l)
    for (int lane = 0; lane < n_in; ++lane) {
      const int from = lane + (1 << l) < n_in ? lane + (1 << l) : lane;
      v[lane] = qz_crc_join(zadv, k0 + l, v[lane], v[from]);
    }
}

// The launch of csrc/checksum.cu run serially: each row's cluster of P
// CTAs (p 0: the launch's own plan), each CTA's threads in order through
// qz_ck_thread, then the joins in the kernel's order (the warp trees, the
// tree over the CTA's 8 warps, rank 0's tree over the CTAs, the finish;
// Adler sums add).  len int32 [rows], or int64 where len64.  out int64
// [rows].
extern "C" void shim_checksum(const uint8_t* data, int64_t stride,
                              const void* len, int len64,
                              const uint32_t* tables, int64_t* out, int rows,
                              int n, int kind, int p) {
  const QzCkArgs a = {data, stride, len, len64, tables, out, rows, n, kind};
  const QzCkPlan pl = p ? qz_ck_plan_p(p, n) : qz_ck_plan(rows, n);
  std::vector<uint32_t> tab(tables, tables + QZ_CK_TABLE_WORDS);
  const uint32_t* zadv = tab.data() + QZ_CK_TAB;
  const int W = QZ_CK_THREADS / 32;
  for (int row = 0; row < rows; ++row) {
    const int L = qz_ck_len(a, row);
    const uint8_t* d = data + row * stride;
    std::vector<uint32_t> ctas(pl.p);
    uint32_t s1 = 0, s2 = 0;
    for (int r = 0; r < pl.p; ++r) {
      std::vector<uint32_t> warps(W);
      for (int w = 0; w < W; ++w) {
        std::vector<uint32_t> lanes(32);
        for (int lane = 0; lane < 32; ++lane) {
          uint32_t v2 = 0;
          qz_ck_thread(pl, tab.data(), kind, d, L, r, 32 * w + lane,
                       &lanes[lane], &v2);
          if (kind == 1) {
            s1 = qz_adler_add(s1, lanes[lane]);
            s2 = qz_adler_add(s2, v2);
          }
        }
        if (kind == 0) shim_crc_tree(zadv, pl.s_lg, 32, lanes);
        warps[w] = lanes[0];
      }
      if (kind == 0) shim_crc_tree(zadv, pl.s_lg + 5, W, warps);
      ctas[r] = warps[0];
    }
    if (kind == 0) {
      shim_crc_tree(zadv, pl.s_lg + 8, pl.p, ctas);
      out[row] = qz_crc_finish(tab.data() + QZ_CK_UNPAD_AT, ctas[0], L);
    } else {
      out[row] = qz_adler_finish(s1, s2, L);
    }
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
        ctypes.c_void_p] * 4
    so.shim_lz4_trace.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]
    so.shim_select.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    so.shim_sort.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_uint32]
    so.shim_schedule.argtypes = [ctypes.c_uint32, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p]
    so.shim_bank_ways.argtypes = [ctypes.c_uint32, ctypes.c_int]
    so.shim_alu.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
    so.shim_rows.argtypes = [ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3
    so.shim_walk.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    so.shim_walk.restype = ctypes.c_uint32
    so.shim_step3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    so.shim_step5.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    so.shim_column_cta.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_uint32,
                                                 ctypes.c_void_p]
    so.shim_row_stage.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    so.shim_s5_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    so.shim_s5_entries.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    so.shim_tokens_tile.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    so.shim_bitonic_stage.argtypes = [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 2
    so.shim_bitonic.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    so.shim_bitonic_row.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    so.shim_indep_unit_at.argtypes = [ctypes.c_int] * 4
    so.shim_indep.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    so.shim_transpose.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    so.shim_tr_plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    so.shim_tr_thread.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    so.shim_dep.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.shim_chain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    so.shim_chain_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    so.shim_chain_cluster.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    so.shim_checksum_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    so.shim_checksum.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
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
            tll[i], td[i] = RPI.static_regions()
        else:
            tll[i] = RPI.build_ll_region(s._lens[0])
            td[i] = RPI.build_d_region(s._lens[1])
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
    assert shim.shim_column_cta(_ptr(t), n, 64, _ptr(got), 8, 11, post,
                                _ptr(np.zeros(3, np.int32))) == 0
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


# column heights from the TPU probes' 8 to 1024 (128 KB staged, four
# boxes), 1 to 8 index rows (the probes' 1 and 8)
@pytest.mark.parametrize("n", [8, 16, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_probe_column_cta_stages_once_and_matches_plain(shim, n, rows):
    """COLUMN as qz_probe_column runs it, a CTA at a time: its tensor
    copies (boxes of at most 256 rows, at most 4 of them, covering the
    block's n rows exactly) write every word of the block's [n][32]
    shared memory exactly once and nothing past it, in the shared memory a
    CTA may take; each lane then reads only its own column; the output
    equals _column for a post of n - 1 and of all ones."""
    rng = np.random.default_rng(n + rows)
    cols = 64
    t, idx = _u32s(rng, (n, cols)), _u32s(rng, (rows, cols))
    for post in (n - 1, 0xFFFFFFFF):
        got = idx.copy()
        info = np.zeros(3, np.int32)
        assert shim.shim_column_cta(_ptr(t), n, cols, _ptr(got), rows, 9,
                                    post, _ptr(info)) == 0
        box, boxes, words = (int(v) for v in info)
        assert box <= 256 and box * boxes == n and boxes <= 4
        assert words == 32 * n and words * 4 + 16 <= PR.MAX_SMEM
        want = PR._column(_ti(t), _ti(idx), 9, post)
        assert (got.view(np.int32) == want.numpy()).all()


_ROW_STAGES = [(kind, lpc) for kind in ("step3", "tokens", "tile")
               for lpc in (1, 2, 4, 8, 16, 32, 64, 128)
               if kind != "tile" or lpc % 4 == 0]


@pytest.mark.parametrize("kind,lpc", _ROW_STAGES)
def test_probe_step_row_stage_plan(shim, kind, lpc):
    """A CTA of STEP3 or TOKENS (lone, or the tile's lanes a multiple of
    4) staging its row at every lanes a CTA: 128 threads (the first lpc
    run the lanes) or, for the tile, whose every thread passes the flush's
    barrier, its lpc; every word it stages stored exactly once from its
    array (STEP3 win, tll and td; TOKENS tll at word 128), no other word
    touched; no thread issuing more loads than the plan says (one, or
    eight for the tile), each all of them before its first store."""
    rng = np.random.default_rng(lpc)
    win, tll, td = (_u32s(rng, 128) for _ in range(3))
    sm = np.zeros(384, np.uint32)
    info = np.zeros(3, np.int32)
    assert shim.shim_row_stage(int(kind == "step3"), int(kind == "tile"),
                               lpc, _ptr(win), _ptr(tll), _ptr(td),
                               _ptr(sm), _ptr(info)) == 0
    threads, per, most = (int(v) for v in info)
    if kind == "tile":
        assert threads == lpc and most <= per <= 8
    else:
        assert threads == 128 and most == per == 1
    garbage = np.full(128, 0xA5A5A5A5, np.uint32)
    want = ([win, tll, td] if kind == "step3" else [garbage, tll, garbage])
    assert (sm == np.concatenate(want)).all()


@pytest.mark.parametrize("rc", [128, 256])
@pytest.mark.parametrize("lpc", [1, 8, 32])
def test_probe_step5_matches_plain(shim, rc, lpc):
    """The kernel's staging plan and widened step, run serially, on random
    cells: every shared-memory word stored once, each lane reading only
    its column and no load of a warp meeting a bank conflict; bitpos and
    every token after each K of 1-12 equal to lane_major_step's, lanes
    near the int32 wrap of bitpos among them."""
    rng = np.random.default_rng(rc + lpc)
    W, sc, lanes = 128, 256, 64
    win = _u32s(rng, (W, lanes))
    tll, td = _u32s(rng, (rc + sc, lanes)), _u32s(rng, (rc + sc, lanes))
    bp = rng.integers(-2000, 1 << 20, (1, lanes)).astype(np.int32)
    bp[0, :3] = [2**31 - 40, -2**31, -1]
    for K in range(1, 13):
        got = bp.copy()
        toks = np.full((K, lanes), 0xFFFFFFFF, np.uint32)
        assert shim.shim_step5(_ptr(win), _ptr(tll), _ptr(td), _ptr(got),
                               _ptr(toks), lanes, K, W, rc, sc, lpc) == 1
        want_bp, want_toks = PR.lane_major_step(
            *map(_ti, (win, tll, td, bp)), K, rc, sc)
        assert (got == want_bp.numpy()).all()
        assert (toks.view(np.int32) == want_toks.numpy()).all()
    assert len(np.unique(toks)) > K * lanes // 4


@pytest.mark.parametrize("rc", [128, 256])
def test_probe_step5_plan_fits_every_lanes_a_cta(shim, rc):
    """A CTA of at least 128 threads, 16-byte loads where its lanes fill a
    vector, at most 9 loads a thread in flight, in the shared memory a CTA
    may take at every lanes a CTA the kernels are built for (at 32 lanes
    and 256 root cells: 1664 words a lane); none at other shapes or lanes
    a CTA."""
    for lpc in PR.STEP5_LPC:
        out = np.zeros(5, np.int32)
        shim.shim_s5_plan(rc, lpc, _ptr(out))
        threads, vec, per, nbytes, items = (int(v) for v in out)
        assert 128 <= threads <= 1024
        assert vec == (4 if lpc >= 4 else 1) and threads * per >= items
        assert items == (128 + 2 * (rc + 256)) * lpc // vec
        assert nbytes == (128 + 4 * rc + 2 * 256) * lpc * 4 <= PR.MAX_SMEM
        assert per <= 9
    for lpc in (2, 4, 16, 64):
        shim.shim_s5_plan(rc, lpc, _ptr(out))
        assert (out == -1).all()
    shim.shim_s5_plan(512, 8, _ptr(out))
    assert (out == -1).all()
    assert shim.shim_step5(*[None] * 5, 8, 1, 64, rc, 256, 8) == -1


def test_probe_step5_widened_entries_match_u16(shim):
    """Every one of the 65536 values of a half, widened as the staging
    widens it: as a root, a pointer exactly where its kind is 3, giving
    the low 9 bits of the u16 entry's subtable index (all that a subtable
    of 256 cells reads) at every row width; as a final litlen entry (from either half
    of a subtable cell, or a root that is no pointer) beside a distance
    entry, the match length, bits2, dist1, adv and tok & 1 of the u16
    entries (the plain version's own arithmetic)."""
    rng = np.random.default_rng(17)
    n = 1 << 16
    h = np.arange(n, dtype=np.uint32)
    b0, b1 = _u32s(rng, n), _u32s(rng, n)
    for hd, rbits in ((h, 9), (rng.permutation(h), 8)):
        out = np.zeros((n, 9), np.uint32)
        shim.shim_s5_entries(_ptr(h), _ptr(hd), _ptr(b0), _ptr(b1), n, rbits,
                             _ptr(out))
        e, ed, tb0, tb1 = (torch.from_numpy(a.astype(np.int64))
                           for a in (h, hd, b0, b1))
        ptr = ((e >> 4) & 3) == 3
        sidx = (((e >> 6) & 0xFF) << 1) + ((tb0 >> rbits)
                                           & ((1 << (e & 15)) - 1))
        assert (out[:, 0] == ptr.numpy()).all()
        assert (out[ptr.numpy(), 1] == (sidx[ptr] & 0x1FF).numpy()).all()
        mlen, used1, is_len = PR._litlen(e, tb0)
        bits2 = PR._funnel(tb0, tb1, used1)
        dist1, dadv = PR._dist(ed, bits2)
        adv = used1 + torch.where(is_len, dadv, 0)
        tok = (2 | (mlen << 2) | (dist1 << 11)) & 0xFFFFFFFF
        for col, want in zip(range(2, 7), (mlen, bits2, dist1, adv,
                                           tok & 1)):
            assert (out[:, col] == want.numpy()).all(), col
        root = ~ptr.numpy()
        assert (out[root, 7] == mlen.numpy()[root]).all()
        both = root & ~(((ed >> 4) & 3) == 3).numpy()
        assert (out[both, 8] == adv.numpy()[both]).all()


# a tile of 8 (the card tests') and 256 (the cases'), 4 to 128 lanes a
# CTA (two 256-row buffers of 128 lanes do not fit: 128 rows each)
@pytest.mark.parametrize("tile,lpc", [(8, 4), (8, 32), (256, 32), (8, 128),
                                      (256, 128)])
def test_probe_tokens_tile_schedule_matches_plain(shim, tile, lpc):
    """The double-buffered token tile run serially: no step rewrites a
    buffer that its bulk copy, issued before the flush's wait, may still
    read; every token stored, equal to tokens_dma at K from one tile to
    five (each buffer reused); the buffers' rows are the wrapper's, at
    most a tensor copy's box of 256."""
    rng = np.random.default_rng(tile + lpc)
    lanes = 256
    t = rng.integers(0, 3, (2, 128)).astype(np.uint32)
    idx = rng.integers(0, 128, lanes).astype(np.int32)
    rows = PR.tokens_rows(tile, lpc)
    assert rows == (128 if (tile, lpc) == (256, 128) else tile)
    for n in range(1, 6):
        K = n * tile
        toks = np.full((K, lanes), 0xFFFFFFFF, np.uint32)
        assert shim.shim_tokens_tile(_ptr(t), _ptr(idx), _ptr(toks), lanes,
                                     lpc, tile, K) == rows
        want, _ = PR.tokens_dma(_ti(t), _ti(idx.reshape(2, 128)), K)
        assert (toks.view(np.int32) == want.numpy()).all()


_SEGMENTS = {"flat": lambda S, L: (S * L, 0, 1),
             "rows": lambda S, L: (L, L, 1),
             "cols": lambda S, L: (S, 1, L)}
_SEG_OF = {"flat": lambda pl, S, L: (0 * pl, pl),
           "rows": lambda pl, S, L: (pl // L, pl % L),
           "cols": lambda pl, S, L: (pl % L, pl // L)}


# the TPU probes' three [8, 128] cases, the shim's other tile shapes, tiles
# of 64 and 4096 elements (one segment of 4096; segments of 2048 across
# warps; segments of 2, two slots a thread)
_BITONIC_TILES = [
    (8, 128, "flat"), (8, 128, "rows"), (8, 128, "cols"), (4, 8, "flat"),
    (16, 64, "cols"), (8, 8, "flat"), (2, 32, "rows"), (64, 1, "cols"),
    (64, 64, "flat"), (32, 128, "rows"), (512, 8, "cols"), (1, 4096, "rows"),
    (2048, 2, "cols"), (2, 2048, "cols")]


@pytest.mark.parametrize("S,L,segment", _BITONIC_TILES)
def test_probe_bitonic_schedule_sorts_each_segment(shim, S, L, segment):
    """Every stage of the network, as the card places it (qzp_bit_plan),
    touches each place of the tile once and pairs index i of a segment
    with i ^ j of the same segment, as the TPU kernels do: within a
    thread for j below its values, else with a lane of the same warp
    (a shuffle) or, past 32 slots, of another warp (shared memory); the
    whole schedule, its shuffles emulated serially, sorts each segment as
    the plain version and np.sort."""
    seg = _SEGMENTS[segment](S, L)
    n, m = S * L, seg[0]
    plan = np.zeros(4, np.int32)
    want = PR.bitonic_plan(n, m)
    k = 2
    while k <= m:
        j = k // 2
        while j >= 1:
            out = np.zeros((n, 4), np.int32)
            shim.shim_bitonic_stage(n, *seg, k, j, _ptr(out), _ptr(plan))
            place, partner, where, q2 = out.T
            assert sorted(place) == list(range(n))
            s0, i0 = _SEG_OF[segment](place, S, L)
            s1, i1 = _SEG_OF[segment](partner, S, L)
            assert (s0 == s1).all() and (i1 == i0 ^ j).all()
            v = int(plan[0])
            q = np.arange(n) // v
            if j < v:
                assert (where == 0).all() and (q2 == q).all()
            elif j < 32 * v:
                assert (where == 1).all() and (q2 // 32 == q // 32).all()
            else:
                assert (where == 2).all() and (q2 // 32 != q // 32).all()
            j //= 2
        k *= 2
    assert list(plan) == [want["v"], want["t"], n // want["v"],
                          want["threads"]]
    assert sum(want["stages"].values()) == (m.bit_length() - 1) * (
        m.bit_length()) // 2
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


def test_probe_bitonic_tiles_the_card_takes():
    """BITONIC's kernel takes tiles of 32 to 4096 elements, powers of 2 on
    both axes, in any of the three segment shapes; any other is refused by
    name.  At [8, 128] the network's 55 / 28 / 6 stages fall 19 / 13 / 6 in
    registers, 30 / 15 / 0 across lanes and 6 / 0 / 0 across warps."""
    for S, L in ((4, 8), (8, 128), (64, 64), (1, 32), (4096, 1), (2, 16)):
        PR.bitonic_check(S, L)
    for bad in ((4, 4), (64, 128), (3, 32), (8, 12), (0, 64), (1, 8192)):
        with pytest.raises(ValueError, match="bitonic runs on the card"):
            PR.bitonic_check(*bad)
    got = [PR.bitonic_plan(1024, m)["stages"] for m in (1024, 128, 8)]
    assert got == [{"regs": 19, "shfl": 30, "smem": 6},
                   {"regs": 13, "shfl": 15, "smem": 0},
                   {"regs": 6, "shfl": 0, "smem": 0}]


def _row_races(masks, nb: int, ctas: int) -> list:
    """The (pass, CTA) of each write of a sort's passes across CTAs that
    nothing orders after its receiver's read of the buffer's previous use.
    Pass p of CTA r writes into CTA r ^ masks[p], buffer p % nb, last used
    by pass p - nb.  Only program order and the exchanges order the CTAs:
    r writes pass p after it has read pass p - 1, and reads pass p after
    it and r ^ masks[p] have written it.  Vector clocks: d[r][s] is the
    last pass that CTA s has read before CTA r's current point (a sort
    starts after the cluster barrier, every buffer read)."""
    d = [[-1] * ctas for _ in range(ctas)]
    races = []
    for p, m in enumerate(masks):
        w = [list(c) for c in d]   # the clocks of the writes of pass p
        races += [(p, r) for r in range(ctas)
                  if p >= nb and w[r][r ^ m] < p - nb]
        for r in range(ctas):
            d[r] = [max(a, b) for a, b in zip(w[r], w[r ^ m])]
            d[r][r] = p
    return races


def _row_plan(shim, ctas: int) -> np.ndarray:
    plan = np.zeros((136, 8), np.int32)
    shim.shim_bitonic_row(_ptr(np.zeros(65536, np.int32)), 1, ctas,
                          _ptr(plan))
    return plan


@pytest.mark.parametrize("ctas", [16, 8])
def test_probe_bitonic_row_plan_sorts_in_signed_order(shim, ctas):
    """The 64K row sort as the card places it (qzp_row_*, 4 values a
    thread; the kernel's cluster of 16 CTAs, and 8 to hold the plan at
    another size): the network's 136 passes in the TPU kernels' order, each
    where the plan says (in registers, a lane within the warp by shuffle,
    another warp of the CTA through shared memory, or the same thread of
    CTA rank ^ (j / N) through its receive buffer), the passes across CTAs
    numbered in order onto buffers p % NB, each waiting for its buffer's
    phase; the whole plan run serially, a CTA at a time with its threads'
    registers as host arrays, sorts full-range int32 rows with negatives
    and repeats as the plain version and np.sort do."""
    plan = _row_plan(shim, ctas)
    k, j, where, slot, partner, p, buf, parity = plan.T
    assert [(int(a), int(b)) for a, b in zip(k, j)] == [
        (1 << a, 1 << b) for a in range(1, 17) for b in range(a - 1, -1, -1)]
    n, v = 65536 // ctas, 4
    assert (where == np.select([j < v, j < 32 * v, j < n], [0, 1, 2], 3)).all()
    cross = where == 3
    assert (partner[cross] == j[cross] // n).all()
    assert set(partner[cross]) == {1 << b for b in range(ctas.bit_length()
                                                         - 1)}
    assert (slot == np.where((where == 1) | (where == 2), j // v, 0)).all()
    lc = ctas.bit_length() - 1
    P, nb = lc * (lc + 1) // 2, {16: 7, 8: 4}[ctas]
    assert list(p[cross]) == list(range(P))
    assert list(buf[cross]) == [q % nb for q in range(P)]
    uses = [sum(1 for q in range(P) if q % nb == b) for b in range(nb)]
    assert list(parity[cross]) == [(uses[q % nb] + q // nb) & 1
                                   for q in range(P)]
    assert (p[~cross] == -1).all() and (buf[~cross] == -1).all()
    rng = np.random.default_rng(ctas)
    x = rng.integers(-2**31, 2**31, (2, 65536)).astype(np.int32)
    x[0, 4096:8192] = x[0, :4096]
    x[1, ::3] = rng.integers(-4, 4, x[1, ::3].shape)
    got = x.copy()
    shim.shim_bitonic_row(_ptr(got), 2, ctas, None)
    ref = PR.bitonic(torch.from_numpy(x).view(2, 512, 128), "flat")
    assert (got == ref.reshape(2, -1).numpy()).all()
    assert (got == np.sort(x, axis=1)).all()


@pytest.mark.parametrize("ctas", [16, 8])
def test_probe_bitonic_row_buffers_never_overwritten_unread(shim, ctas):
    """No write of a pass across CTAs reaches a receive buffer before the
    CTA that owns it has read the buffer's previous use: the partners'
    masks of the passes in between lead back to it.  The plan's NB (7 at
    16 CTAs, 4 at 8) is the least that holds; two buffers by turns would
    race (a CTA can be passes ahead of one it has not met yet).  What a
    CTA of the kernel keeps (4096 values; two buffers for the passes
    across warps, NB receive buffers, their mbarriers) fits its shared
    memory."""
    plan = _row_plan(shim, ctas)
    cross = plan[:, 2] == 3
    masks = [int(m) for m in plan[cross, 4]]
    nb = int(plan[cross, 6].max()) + 1
    assert nb == {16: 7, 8: 4}[ctas]
    assert _row_races(masks, nb, ctas) == []
    assert _row_races(masks, nb - 1, ctas)
    assert _row_races(masks, 2, ctas)
    if ctas == PR.ROW_CTAS:
        assert (2 + nb) * 4096 * 4 + 8 * nb <= PR.MAX_SMEM


def _shim_indep(shim, W, R, t, idx, K, addrs=None):
    got = idx.copy()
    rows, cols = idx.shape
    staged = np.zeros((t.shape[1] + W - 1) * max(R, 32), np.uint32)
    r = shim.shim_indep(W, R, _ptr(t), t.shape[0], t.shape[1], _ptr(got),
                        rows, cols, K, _ptr(staged),
                        None if addrs is None else _ptr(addrs))
    return r, got, staged


# R = 32 down to 1 on the probe's 128-word rows (a row an index row), and
# a one-row table of 2048 words (the card's R 16) for every row
@pytest.mark.parametrize("W", [4, 8])
@pytest.mark.parametrize("R,w,t_rows", [(32, 128, 6), (16, 128, 6),
                                        (8, 128, 6), (4, 128, 6),
                                        (2, 128, 6), (1, 128, 6),
                                        (0, 2048, 1), (0, 8, 6),
                                        (0, 4, 6), (8, 2, 6), (0, 1, 6)])
def test_probe_indep_layout_matches_plain(shim, W, R, w, t_rows):
    """INDEP over a table row staged R times over with its first W - 1
    words wrapped past its end: every staged word stored once, lane l
    finding word i's copy l % R at i R + l % R for every i < w + W - 1
    (word i % w), and K steps of one mask, one address and W loads each
    equal to the plain version; R = 0 takes the card's choice."""
    rng = np.random.default_rng(W * 64 + R + w)
    t, idx = _u32s(rng, (t_rows, w)), _u32s(rng, (6, 40))
    r, got, staged = _shim_indep(shim, W, R, t, idx, 7)
    assert r == (R or PR.indep_copies(w, W)) and r > 0
    assert (got.view(np.int32) == PR.indep_gather_loop(
        _ti(t), _ti(idx), 7, W).numpy()).all()
    i = np.arange(w + W - 1)[:, None]
    lanes = np.arange(32)[None, :]
    shift = (4 * r).bit_length() - 1
    assert (staged[i * r + (lanes & (r - 1))] == (
        t[0][i % w].astype(np.uint64) << shift).astype(np.uint32)).all()


@pytest.mark.parametrize("R", [32, 16, 8, 4])
def test_probe_indep_staging_stores_spread_over_the_banks(shim, R):
    """The staging's 16-byte stores: a quarter warp's 8 threads, each
    storing unit j of its own word, fill 8 distinct 16-byte bank groups at
    R = 32 and 4, and queue at most 32 / R deep below 32."""
    for t0 in range(0, 128, 8):
        for j in range(R // 4):
            groups = [shim.shim_indep_unit_at(R, t, j, t) // 4 % 8
                      for t in range(t0, t0 + 8)]
            ways = max(groups.count(g) for g in groups)
            assert ways == 1 if R in (32, 4) else ways <= 32 // R


@pytest.mark.parametrize("R", [32, 16, 8, 4, 2, 1])
def test_probe_indep_loads_fall_on_distinct_banks(shim, R):
    """Whatever the 32 lanes' indexes, each of a step's W loads of a warp
    falls on 32 distinct banks at R = 32 (one wavefront), and at R < 32
    queues at most 32 / R distinct words on a bank; indexes that meet on
    a bank reach that bound."""
    rng = np.random.default_rng(R)
    w, W = 2048, 8
    t = _u32s(rng, (1, w))
    sets = [_u32s(rng, (1, 32)) for _ in range(50)]
    sets += [np.zeros((1, 32), np.uint32),
             (np.arange(32, dtype=np.uint32) * 37)[None, :],
             ((np.arange(32, dtype=np.uint32) // R) * (32 // R))[None, :]
             if R < 32 else np.zeros((1, 32), np.uint32)]
    worst = 0
    for idx in sets:
        addrs = np.zeros((32, W), np.uint32)
        _shim_indep(shim, W, R, t, idx, 1, addrs)
        for x in range(W):
            words = addrs[:, x] // 4
            ways = max(len(set(words[words % 32 == b])) for b in range(32))
            if R == 32:
                assert len(set(words % 32)) == 32
            assert ways <= 32 // R
            worst = max(worst, ways)
    assert worst == 32 // R


_PALLAS_ROLL = [(16, 1, 0), (16, 4, 0), (512, 1, 0), (512, 64, 0),
                (512, 256, 0), (512, 448, 0), (8, 32, 1), (8, 96, 1),
                (8, 127, 1)]


# the nine cases of probe_pallas3.py's main (p_roll's [8, 128] lanes among
# them), rows of 16-byte vectors and of words
@pytest.mark.parametrize("S,shift,axis", _PALLAS_ROLL)
def test_probe_roll_schedule_matches_plain(shim, S, shift, axis):
    """Each output word stored once, from the word np.roll names; rows
    move in CTAs of at most 256 threads, lanes up to 32 rows a CTA."""
    x = np.random.default_rng(S + shift).integers(
        0, 1 << 32, (S, 128), dtype=np.uint64).astype(np.uint32)
    want = PR.roll(_ti(x), shift, axis).numpy()
    assert (want == np.roll(x.view(np.int32), shift, axis)).all()
    if axis == 1:
        got = np.zeros_like(x)
        assert shim.shim_roll_lanes(_ptr(x), _ptr(got), S, shift) == min(S,
                                                                         32)
        assert (got.view(np.int32) == want).all()
        return
    for vec in (4, 1):
        got, writes = np.zeros_like(x), np.zeros(x.shape, np.int32)
        ctas = shim.shim_roll_rows(_ptr(x), _ptr(got), _ptr(writes), S, 128,
                                   shift, vec)
        assert ctas == -(-S // (256 * vec // 128))
        assert (writes == 1).all()
        assert (got.view(np.int32) == want).all()


# ragged tiles: a row of 3 or 25 vectors, and rows that are not 16-byte
# aligned (words)
@pytest.mark.parametrize("S,cols,shift,vec", [(5, 12, 2, 4), (5, 12, 4, 1),
                                              (300, 100, 299, 4),
                                              (77, 100, 1, 1), (1, 4, 0, 4)])
def test_probe_roll_rows_ragged_tiles(shim, S, cols, shift, vec):
    x = np.random.default_rng(S).integers(0, 1 << 32, (S, cols),
                                          dtype=np.uint64).astype(np.uint32)
    got, writes = np.zeros_like(x), np.zeros(x.shape, np.int32)
    assert shim.shim_roll_rows(_ptr(x), _ptr(got), _ptr(writes), S, cols,
                               shift, vec) > 0
    assert (writes == 1).all()
    assert (got.view(np.int32) == PR.roll(_ti(x), shift, 0).numpy()).all()


# windows of 1 word to 128, offsets of every residue mod 4, odd refills
# moved by 0, 3 (unaligned) or 64 words; rows of 16-byte vectors (vec 1) or
# of a ragged 509 words (vec 0)
@pytest.mark.parametrize("win", [1, 61, 64, 127, 128])
@pytest.mark.parametrize("vec", [0, 1])
def test_probe_refill_span_matches_plain(shim, win, vec):
    rng = np.random.default_rng(win * 2 + vec)
    rows, cols = 12, 512 if vec else 509
    x = rng.integers(0, 1 << 32, (rows, cols), dtype=np.uint64).astype(
        np.uint32)
    for alt in (0, 3, 64):
        off = rng.integers(0, cols - win - alt + 1, rows).astype(np.int32)
        off[:4] = (off[:4] & ~3) + np.arange(4)
        off[4] = cols - win - alt   # the last window that fits
        for K in (1, 2, 3):
            got = np.zeros((rows, win), np.uint32)
            assert shim.shim_refill(_ptr(x), _ptr(got), _ptr(off), rows, cols,
                                    alt, win, K, vec) == 0
            want = PR._refill(_ti(x), _ti(off), win, K, alt)
            assert (got.view(np.int32) == want.numpy()).all()


# every tile qz_probe_transpose takes (the wrapper pads n < 4 to 4); K 0-5
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 128])
def test_probe_transpose_cluster_matches_plain(shim, n):
    """The cluster's block map run a CTA's step at a time: no step writes
    a buffer it reads, every output word is stored once, and K steps
    equal K plain transposes; the plan is the wrapper's and puts 16 CTAs
    on the TPU probe's [128, 128] tile."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 32, (n, n), dtype=np.uint64).astype(np.uint32)
    plan = np.zeros(5, np.int32)
    shim.shim_tr_plan(n, _ptr(plan))
    want_plan = PR.transpose_plan(n)
    assert list(plan) == [want_plan[k] for k in ("b", "nb", "ctas",
                                                 "stride", "threads")]
    assert plan[2] == max(1, (n // 32) ** 2) and plan[4] <= 256
    for K in range(6):
        got = np.zeros_like(x)
        assert shim.shim_transpose(_ptr(x), _ptr(got), n, K) == plan[2]
        want = PR.transpose(_ti(x), K).numpy()
        assert (got.view(np.int32) == want).all()


def test_probe_transpose_step_has_no_bank_conflicts(shim):
    """At a 32 x 32 block, a warp's reads of its own buffer fall on 32
    banks for each of a thread's words, and its stores into the partner's
    buffer on 32 banks a transaction (8 threads' 16-byte stores); each
    thread stores 4 consecutive words of one row, the same column of its
    4 rows."""
    p = PR.transpose_plan(128)
    for w0 in range(0, p["threads"], 32):
        offs = []
        for t in range(w0, w0 + 32):
            so, do = np.zeros(4, np.int32), np.zeros(4, np.int32)
            assert shim.shim_tr_thread(128, t, _ptr(so), _ptr(do)) == 4
            assert (np.diff(do) == 1).all() and (np.diff(so) == p["stride"]
                                                 ).all()
            offs.append((so, do))
        for e in range(4):
            assert len({int(so[e]) % 32 for so, _ in offs}) == 32
        for g in range(4):
            part = offs[g * 8:(g + 1) * 8]
            banks = [int(w) % 32 for _, do in part for w in do]
            assert sorted(banks) == list(range(32))


# per-row tables (the TPU probes' shapes, p_gather's [8, 1024] a cluster
# of 8 CTAs a row, the inflate's 8 KB a lane), one-row tables (p_tbl's,
# a ragged width, short rows packed), rows wider than a cluster of
# 128-thread CTAs, tables too narrow for 16-byte staging
@pytest.mark.parametrize("rows,cols,t_rows,w", [
    (8, 128, 8, 128), (8, 1024, 8, 1024), (16, 128, 16, 128),
    (64, 1, 64, 2048), (512, 128, 1, 1024), (16, 300, 1, 2048),
    (3, 2000, 3, 64), (2, 5000, 2, 256), (5, 7, 1, 2), (1, 33, 1, 8),
    (40, 64, 1, 512), (4, 2048, 4, 2048), (2, 16384, 2, 128),
    (1, 1, 1, 1), (9, 129, 1, 4)])
def test_probe_dep_plan_stages_each_table_row_once(shim, rows, cols, t_rows,
                                                   w):
    """The CTAs of a row of indexes form a cluster of at most 16 that
    stages its table row once: every word loaded once (16-byte vectors
    where the width allows) and stored once into each CTA's shared
    memory; a CTA holds at most 128 threads unless its row of indexes is
    wider than 16 of them; one cluster a table row where the table has a
    row an index row; each output stored once, equal to
    dep_gather_loop."""
    rng = np.random.default_rng(rows + cols + w)
    t = rng.integers(0, 1 << 32, (t_rows, w), dtype=np.uint64).astype(
        np.uint32)
    idx = rng.integers(0, 1 << 32, (rows, cols), dtype=np.uint64).astype(
        np.uint32)
    want = PR.dep_gather_loop(_ti(t), _ti(idx), 5).numpy()
    for vec in ((0, 1) if w % 4 == 0 else (0,)):
        got, writes = np.zeros_like(idx), np.zeros(idx.shape, np.int32)
        plan = np.zeros(4, np.int32)
        staged = shim.shim_dep(_ptr(t), t_rows, w, _ptr(idx), _ptr(got),
                               _ptr(writes), rows, cols, 5, vec, _ptr(plan))
        tx, ty, gx, gy = (int(v) for v in plan)
        assert staged == gy and tx * ty <= (128 if cols <= 16 * 128
                                            else 1024)
        assert gx == -(-cols // tx) and gx <= 16
        if t_rows == rows and rows > 1:
            assert ty == 1 and gy == rows   # a cluster a table row
        else:
            assert gy == -(-rows // min(rows, max(1, 128 // tx)))
        assert (writes == 1).all()
        assert (got.view(np.int32) == want).all()


def test_probe_entries_take_only_their_arguments():
    """Each C entry of probes.cu takes exactly the ctypes arguments its
    wrapper declares (a pointer, an unsigned or an int each), ROLL,
    REFILL, TRANSPOSE, DEP, STEP, COLUMN, INDEP and the 64K row sort only
    their own; TRANSPOSE, DEP, STEP, COLUMN, INDEP and the row sort set
    their kernels' attributes once a process, in a static initialiser,
    never at a launch; the row
    roll's kernel keeps no shared memory and no barrier."""
    import re

    src = open(os.path.join(_build.TOOLS, "probes.cu")).read()
    kinds = {ctypes.c_void_p: "p", ctypes.c_uint: "u", ctypes.c_int: "i"}
    for k in PR.KERNELS.values():
        m = re.search(r'extern "C" int %s\(([^)]*)\)' % k.symbol, src)
        params = [a.strip() for a in m.group(1).split(",") if a.strip()]
        declared = ["p" if "*" in a else "u" if a.startswith("unsigned")
                    else "i" for a in params]
        assert declared == [kinds[t] for t in k.argtypes], k.symbol
    assert [len(k.argtypes) for k in (PR.ROLL, PR.REFILL, PR.TRANSPOSE,
                                      PR.DEP, PR.STEP, PR.COLUMN,
                                      PR.INDEP, PR.ROW)] == [7, 11, 6, 11, 17,
                                                             11, 12, 6]
    for entry, prepare in (("qz_probe_transpose", "qzp_transpose_prepare"),
                           ("qz_probe_dep", "qzp_dep_prepare"),
                           ("qz_probe_step", "qzp_step_prepare"),
                           ("qz_probe_column", "qzp_column_prepare"),
                           ("qz_probe_indep", "qzp_indep_prepare"),
                           ("qz_probe_bitonic_row", "qzp_row_prepare")):
        start = src.index(f'extern "C" int {entry}(')
        body = src[start:src.index("\n}\n", start)]
        assert f"static const int ready = {prepare}();" in body
        assert "cudaFuncSetAttribute" not in body and "qzp_smem" not in body
        assert src.count(f"{prepare}()") == 2   # defined once, called once
    body = src[src.index("__global__ void qzp_roll_rows"):
               src.index("__global__ void qzp_roll_lanes")]
    assert "__shared__" not in body and "__syncthreads" not in body


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


def _shim_lz4(shim, arr, lens, outcap: int, lz4s: bool, base: int,
              stats: np.ndarray | None = None):
    """The shim on a group; every byte it read from the staged input is
    the block's (none at or past a row's length) and every window byte the
    output's.  ``stats`` (int64[8]) takes the shim's counts: input bytes
    read from the ring and from device memory, window reads, bytes
    staged."""
    B, n = arr.shape
    out = np.zeros((B, outcap), np.uint8)
    tot = np.zeros(B, np.int32)
    err = np.zeros(B, np.uint8)
    stats = np.zeros(8, np.int64) if stats is None else stats
    shim.shim_lz4(_ptr(arr), _ptr(lens), B, n, outcap, int(lz4s), base,
                  _ptr(out), _ptr(tot), _ptr(err), _ptr(stats))
    assert stats[2] == 0 and stats[4] == 0, stats
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


def _shim_trace(shim, blk: bytes, lz4s: bool = False, base: int = 2,
                outcap: int = LD.MAX_OUT):
    """One block through the shim with its rounds noted: (out, tot, err,
    stats, heads [rounds, 8], records [sequences, 5]) (QzHostCta)."""
    arr, lens = _lz4_rows([blk])
    out = np.zeros(outcap, np.uint8)
    tot = np.zeros(1, np.int32)
    err = np.zeros(1, np.uint8)
    stats = np.zeros(8, np.int64)
    heads = np.zeros((4096, 8), np.int32)
    recs = np.zeros((65536, 5), np.int32)
    nout = np.zeros(2, np.int32)
    shim.shim_lz4_trace(_ptr(arr), int(lens[0]), arr.shape[1], outcap,
                        int(lz4s), base, _ptr(out), _ptr(tot), _ptr(err),
                        _ptr(stats), _ptr(heads), len(heads), _ptr(recs),
                        len(recs), _ptr(nout))
    assert (nout >= 0).all() and stats[2] == 0 and stats[4] == 0, stats
    return (out, int(tot[0]), bool(err[0]), stats, heads[:nout[0]],
            recs[:nout[1]])


@pytest.mark.parametrize("kind", ["text", "sized", "wrapped"])
def test_lz4_header_queue_order_and_rounds(shim, corpus_factory, kind):
    """The parse warp's queue: round k fills slot k & 1 with up to 64
    records, a round ending short of 64 only when its input span has
    reached 1 KB (QZ_LZ4_SPAN) or it is the last, each round's input span
    starting where the one before ended; the records in queue order are
    the block's sequences in order, and the heads' output counts their
    bytes.  Nearly every header and literal byte of a corpus block comes
    from the staged ring, not device memory."""
    blk = {"text": lambda: lz4_block_compress(corpus_factory(30000, "text")),
           "sized": lambda: LC.sized_block(6000, 1),
           "wrapped": lambda: dict(LC.ring_edge_blocks())["window wrapped"]
           }[kind]()
    out, tot, err, stats, heads, recs = _shim_trace(shim, blk)
    seqs = LC.sequences(blk)
    assert not err and tot == sum(s[1] + s[3] for s in seqs)
    assert out[:tot].tobytes() == LC.host_decode(blk, False, 0, LD.MAX_OUT)
    assert [tuple(r[1:]) for r in recs] == seqs
    rounds = len(heads)
    assert heads[:, 0].tolist() == list(range(rounds))
    assert heads[:, 1].tolist() == [k & 1 for k in range(rounds)]
    assert (heads[:, 4] <= 64).all() and heads[:, 4].sum() == len(seqs)
    short = (heads[:-1, 4] < 64) & (heads[:-1, 3] - heads[:-1, 2] < 1024)
    assert not short.any()
    assert heads[0, 2] == 0 and heads[-1, 3] == len(blk)
    assert (heads[1:, 2] == heads[:-1, 3]).all()
    assert heads[:, 6].tolist() == [0] * (rounds - 1) + [1]
    assert not heads[:, 7].any()
    assert recs[:, 0].tolist() == sum(([k] * c for k, c in
                                       enumerate(heads[:, 4])), [])
    adv = np.cumsum([s[1] + s[3] for s in seqs])
    assert heads[:, 5].tolist() == [int(adv[c - 1])
                                    for c in np.cumsum(heads[:, 4])]
    if kind != "wrapped":
        assert stats[0] > 0.97 * (stats[0] + stats[1]), stats
    assert stats[5] <= len(blk) + 2 * 4096


@pytest.mark.parametrize("lz4s", [False, True])
def test_lz4_header_ring_edges(shim, lz4s):
    """Output past the 64 KB match window, matches at offset 1 and 65535
    across its edge (one ending at MAX_OUT), matches after a wrap, and
    blocks that end exactly at an input refill boundary or a byte past it:
    equal to the plain version and the host decoder; every window read is
    the output byte at its position (the shim's hooks)."""
    names, blocks = zip(*LC.ring_edge_blocks())
    stats = np.zeros(8, np.int64)
    arr, lens = _lz4_rows(blocks)
    got = _shim_lz4(shim, arr, lens, LD.MAX_OUT, lz4s, 2, stats)
    plain = tuple(t.numpy() for t in LD._decode_blocks_impl(
        torch.from_numpy(arr), torch.from_numpy(lens), arr.shape[1],
        LD.MAX_OUT, lz4s, 2))
    assert _same_rows(got, plain).all()
    for r, blk in enumerate(blocks):
        want = LC.host_decode(blk, lz4s, 2, LD.MAX_OUT)
        assert got[2][r] == (want is None), names[r]
        if want is not None:
            assert got[0][r, :got[1][r]].tobytes() == want, names[r]
    if not lz4s:
        assert not got[2].any()
        row = dict(zip(names, range(len(names))))
        assert got[1][row["offset 65535 source across the edge, output at "
                          "MAX_OUT"]] == LD.MAX_OUT
        assert got[1][row["window wrapped"]] > 65536 + 50000
    assert stats[3] > 100000


# ------------------------------------------------------------ chain walk
def _shim_chain(shim, f: np.ndarray, seg: int) -> np.ndarray:
    """csrc/chain.cu's three launches through the shim: int32 [B, nseg,
    seg]."""
    f = np.ascontiguousarray(f, np.int32)
    B, n = f.shape
    out = np.empty((B, n), np.int32)
    ent = np.empty((B, n // seg), np.int32)
    shim.shim_chain(_ptr(f), _ptr(out), _ptr(ent), B, n, seg)
    return out.reshape(B, n // seg, seg)


@pytest.fixture(scope="module")
def chain_cases():
    from tests.test_torch_chain import maps

    return maps()


@pytest.mark.parametrize("k", range(9))
def test_chain_header_matches_torch_reference(shim, chain_cases, k):
    """The kernel's three phases, run serially, equal chain_walk_ref on
    random maps, steps of 1 (the backward pass against the doubling), maps
    that jump to n, and the engines' maps (a K1 batch, a spec round)."""
    label, f, seg = chain_cases[k]
    want = CH.chain_walk_ref(torch.from_numpy(f), seg).numpy()
    assert (_shim_chain(shim, f, seg) == want).all(), label


@pytest.mark.parametrize("B,n,seg", [(1, 32, 32), (33, 64, 32),
                                     (5, 8192, 512), (2, 1024, 1024)])
def test_chain_header_partial_warps_and_widths(shim, B, n, seg):
    """Segment counts that leave a warp partly idle (1, 66, 80 segments),
    a row of one segment and the widest segment the kernel takes."""
    rng = np.random.default_rng(B * n + seg)
    pos = np.arange(n)[None, :]
    f = np.minimum(pos + rng.integers(1, 2 * seg, (B, n)), n).astype(
        np.int32)
    want = CH.chain_walk_ref(torch.from_numpy(f), seg).numpy()
    assert (_shim_chain(shim, f, seg) == want).all()


def _shim_cluster(shim, f: np.ndarray, seg: int,
                  share: int = CH.CLUSTER_SHARE, met: list | None = None
                  ) -> np.ndarray:
    """csrc/chain.cu's cluster launch through the shim: int32 [B, nseg,
    seg]; the plan must take the cluster path.  ``met`` gets [B, C]: the
    segments each CTA's walk from its true entry took before it met the
    walk from its guess."""
    f = np.ascontiguousarray(f, np.int32)
    B, n = f.shape
    c = CH.cluster_plan(n, seg, share)[0]
    assert c > 0
    out = np.empty((B, n), np.int32)
    took = np.zeros((B, c), np.int32)
    assert shim.shim_chain_cluster(_ptr(f), _ptr(out), B, n, seg, share,
                                   _ptr(took)) == c
    if met is not None:
        met.append(took)
    return out.reshape(B, n // seg, seg)


@pytest.mark.parametrize("k", range(9))
@pytest.mark.parametrize("share", [CH.CLUSTER_SHARE, 1024])
def test_chain_cluster_header_matches_torch_reference(shim, chain_cases, k,
                                                      share):
    """The cluster path run serially, a CTA at a time, equals
    chain_walk_ref on every kind of map, at the card's share (one CTA a
    row here) and at shares of 1024 words (2-8 CTAs a row, the entries
    handed from CTA to CTA)."""
    label, f, seg = chain_cases[k]
    want = CH.chain_walk_ref(torch.from_numpy(f), seg).numpy()
    assert (_shim_cluster(shim, f, seg, share) == want).all(), label


@pytest.mark.parametrize("B,n,seg,share,most", [
    (2, 8192, 32, 512, 1500),      # 16 CTAs of 16 segments
    (3, 4096, 32, 512, 1500),      # 8 CTAs of 16 segments; jumps over two
    (2, 8192, 64, 1024, 3000),     # 8 CTAs of 16 segments
    (4, 2560, 32, 512, 600),       # 5 CTAs, the last of 16 segments
    (2, 1440, 32, 256, 200),       # 6 CTAs of 8 segments, the last of 5
    (1, 2048, 256, 1024, 2048),    # 2 CTAs of 4 segments, jumps to n
    (5, 5120, 256, CH.CLUSTER_SHARE, 300)])   # 1 CTA of 20 segments
def test_chain_cluster_entries_walk_across_shares(shim, B, n, seg, share,
                                                  most):
    """Maps whose chains jump over whole segments and whole CTA shares, on
    clusters of 1-16 CTAs with a last CTA that holds fewer segments: the
    entries each CTA hands to the next, and the walks, equal
    chain_walk_ref."""
    from tests.test_torch_chain import random_map

    f = random_map(B, n, B * n + seg, most=most)
    want = CH.chain_walk_ref(torch.from_numpy(f), seg).numpy()
    assert (_shim_cluster(shim, f, seg, share) == want).all()


def test_chain_cluster_walks_meet_their_guesses(shim, chain_cases):
    """Phase B walks each CTA's share from its first position before the
    true entry arrives, then from the entry until the two walks meet.  On
    the decoder's map, steps of 1 and the encoder's rows of text, random
    and iterative data they meet within two segments (so the walk from CTA
    to CTA is short); the parse of a constant row is periodic (258-byte
    matches) and its two walks keep their phase: the second walk takes
    the whole share, as a walk without a guess would.  So does a map of
    two chains that never meet (odd positions from 0, even ones from every
    guess); the walk is right either way."""
    for label, f, seg in chain_cases:
        if label.startswith(("encoder", "decoder", "steps")):
            met = []
            _shim_cluster(shim, f, seg, 1024, met)
            rows = [2] if label.startswith("encoder") else []
            assert np.delete(met[0], rows, axis=0).max() <= 2, label
    n, seg = 4096, 32
    f = np.minimum(np.arange(n) + 2, n).astype(np.int32)[None, :]
    f[0, 0] = 1
    met = []
    got = _shim_cluster(shim, f, seg, 512, met)
    assert (got == CH.chain_walk_ref(torch.from_numpy(f), seg).numpy()).all()
    assert (met[0][0, 1:] == 16).all()


def _shim_plan(shim, n: int, seg: int, share: int) -> tuple:
    info = np.zeros(4, np.int32)
    shim.shim_chain_plan(n, seg, share, _ptr(info))
    return tuple(int(v) for v in info)


def test_chain_cluster_plan_splits_rows_as_the_wrapper_says(shim):
    """qz_chain_plan's split of a row into CTAs and segments equals
    chain.cluster_plan (which picks the wrapper's path) on every shape
    the engines and chip_smoke give it and a grid around them; every CTA
    holds at least one segment, the shared memory fits the H100's 227 KB,
    and each CTA's 256 threads cover its segments' parts."""
    grid = [(n, seg, share) for seg in (32, 64, 128, 256, 512, 1024)
            for n in (seg, 3 * seg, 4096, 5120, 65536, 1 << 17, 1 << 18,
                      (1 << 18) + 1024, 1 << 19, 1 << 22) if n % seg == 0
            for share in (CH.CLUSTER_SHARE, 1024)]
    for n, seg, share in grid:
        c, spc, parts, smem = _shim_plan(shim, n, seg, share)
        assert (c, spc) == CH.cluster_plan(n, seg, share), (n, seg, share)
        if c:
            assert (c - 1) * spc < n // seg <= c * spc <= c * 256
            assert smem <= 232448 and parts * spc <= 256
            assert seg // parts >= 4
    assert CH.cluster_plan(65536, 256) == (2, 128)
    assert CH.cluster_plan(1 << 18, 512) == (8, 64)
    assert CH.cluster_plan(1 << 19, 512) == (16, 64)
    assert CH.cluster_plan(1 << 20, 512) == (0, 0)
    assert CH.cluster_plan(1 << 22, 32) == (0, 0)


# ------------------------------------------------------------- checksums
def _shim_checksum(shim, data: np.ndarray, lens, n: int, kind: str,
                   p: int = 0, len64: bool = False) -> list:
    """csrc/checksum.cu's launch through the shim, rows of data at its
    row stride: the launch's own slicing (p 0) or p CTAs a row."""
    data = np.ascontiguousarray(data, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64 if len64 else np.int32)
    out = np.zeros(len(lens), np.int64)
    shim.shim_checksum(_ptr(data), data.shape[1], _ptr(lens), int(len64),
                       _ptr(CK.kernel_tables()), _ptr(out), len(lens), n,
                       int(kind == "adler32"), p)
    return [int(v) for v in out]


def _rows(lengths, width: int, seed: int, fill=None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (len(lengths), width), dtype=np.uint8)
    if fill is not None:
        data[:] = fill
    return data


_SWEEP = list(range(0, 65)) + [120, 121, 126, 127, 128, 129, 255, 256, 257,
                               511, 512, 513, 1000, 1023, 1024]


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
@pytest.mark.parametrize("n,width,lengths", [
    (1024, 1024, _SWEEP), (1024, 1027, _SWEEP),
    (65536, 65544, [0, 1, 3, 4, 1023, 1024, 1025, 65535, 65536, 40000,
                    255 * 256 + 1, 255 * 256 - 1, 3077])])
def test_checksum_header_length_sweep(shim, kind, n, width, lengths):
    """Every length of test_checksum_length_sweep and lengths around a
    thread's slice at 64 KB, rows wider than n (the encoder's staging) and
    rows 1027 bytes apart (not 8-byte aligned: read a byte a load): equal
    to zlib and to the plain version."""
    data = _rows(lengths, width, 21)
    got = _shim_checksum(shim, data, lengths, n, kind)
    want = [getattr(zlib, kind)(data[i, :k].tobytes())
            for i, k in enumerate(lengths)]
    assert got == want
    plain = getattr(CK, f"{kind}_blocks_ref")(
        torch.from_numpy(data), torch.tensor(lengths, dtype=torch.int32), n)
    assert got == plain.tolist()


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
@pytest.mark.parametrize("fill", [0xFF, 0x00])
def test_checksum_header_runs_at_full_length(shim, kind, fill):
    """Rows of 0xFF and of zeros at full length: 64 KB (the engines'
    chunks) against zlib and the plain version, and 2 MB, where each
    thread's slice passes zlib's 5552-byte reduction bound, against zlib."""
    n = 65536
    lengths = [n, n - 1, n // 2, 1]
    data = _rows(lengths, n, 0, fill)
    want = [getattr(zlib, kind)(data[i, :k].tobytes())
            for i, k in enumerate(lengths)]
    assert _shim_checksum(shim, data, lengths, n, kind) == want
    plain = getattr(CK, f"{kind}_blocks_ref")(
        torch.from_numpy(data), torch.tensor(lengths, dtype=torch.int32), n)
    assert plain.tolist() == want
    big = 1 << 21
    row = np.full((1, big), fill, np.uint8)
    for k in (big, big - 3):
        assert _shim_checksum(shim, row, [k], big, kind) == [
            getattr(zlib, kind)(row[0, :k].tobytes())]


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n,width", [(65536, 65544), (8192, 8195)])
def test_checksum_header_multi_cta_slicing_and_joins(shim, kind, p, n,
                                                     width):
    """The slicing over p CTAs a row and the joins of the slices (the warp
    trees, the CTA's, the cluster's, the finish) at lengths 0, 1, 7, 8,
    n - 1 and n and around a slice's, a warp's and a CTA's bytes, on rows
    8-byte aligned (8 bytes a load) and rows 8195 bytes apart (a byte a
    load): equal to zlib, with int32 and int64 lengths."""
    info = np.zeros(3, np.int32)
    shim.shim_checksum_plan(1, n, p, _ptr(info))
    s, slices = 1 << int(info[1]), 1 << (int(info[2]) - int(info[1]))
    assert int(info[0]) == p and s * slices >= n and s >= 8
    assert slices == 256 * p
    lengths = sorted({k for k in (0, 1, 7, 8, 9, s - 1, s, s + 1, 32 * s,
                                  32 * s + 5, 256 * s - 3, n - 1, n)
                      if 0 <= k <= n})
    data = _rows(lengths, width, 40 + p)
    want = [getattr(zlib, kind)(data[i, :k].tobytes())
            for i, k in enumerate(lengths)]
    for len64 in (False, True):
        assert _shim_checksum(shim, data, lengths, n, kind, p, len64) == want


def test_checksum_plan_fills_the_card(shim):
    """The launch's CTAs a row: 8 for a spec round's 8 rows of 64 KB, 1 for
    an encoder batch's 128 rows, 2 for 64, 1 for rows under 8 KB; the
    slices span at least n."""
    info = np.zeros(3, np.int32)
    for rows, n, p in ((8, 65536, 8), (128, 65536, 1), (64, 65536, 2),
                       (1, 65536, 8), (512, 65536, 1), (80, 1024, 1),
                       (8, 1 << 24, 8)):
        shim.shim_checksum_plan(rows, n, 0, _ptr(info))
        assert int(info[0]) == p, (rows, n)
        assert 1 << int(info[2]) >= n


def _raw_crc(data: bytes, c: int = 0) -> int:
    """The reflected CRC-32 register after data from c, bit by bit."""
    for byte in data:
        c ^= byte
        for _ in range(8):
            c = (c >> 1) ^ (0xEDB88320 if c & 1 else 0)
    return c


def _apply(cols, v: int) -> int:
    out = 0
    for b in range(32):
        if (v >> b) & 1:
            out ^= int(cols[b])
    return out


def test_checksum_kernel_tables():
    """The kernel's tables (checksums.kernel_tables): slice-by-8 table j
    holds the register after a byte and j zero bytes; the zero-advance
    matrices advance a register over 2^k zero bytes; the unpad matrices
    undo an advance over 0-7 zero bytes."""
    t = CK.kernel_tables()
    assert t.dtype == np.uint32 and t.size == 2048 + 25 * 32 + 8 * 32
    rng = np.random.default_rng(9)
    for j in range(8):
        for x in (0, 1, 0x80, 0xFF, int(rng.integers(256))):
            assert int(t[256 * j + x]) == _raw_crc(bytes([x] + [0] * j))
    zadv = t[2048:2048 + 800].reshape(25, 32)
    unpad = t[2848:].reshape(8, 32)
    for v in (1, 0xFFFFFFFF, int(rng.integers(1 << 32))):
        for k in (0, 3, 7):
            assert _apply(zadv[k], v) == _raw_crc(bytes(1 << k), v)
        for pad in range(8):
            assert _apply(unpad[pad], _raw_crc(bytes(pad), v)) == v
