// The per-step bodies of the Hopper counterparts of the Mosaic construct
// probes (tools/probe_pallas*.py, tools/probe_inflate_step*.py).
//
// Each function is one step of a TPU probe's loop, for ONE element or lane,
// in 32-bit arithmetic with the probe's own semantics: int32 values where
// the probe computes in int32 (arithmetic right shifts, wrapping sums),
// uint32 where it computes in uint32.  A table the step reads is passed as
// a pointer and the stride between its consecutive entries, so that the
// kernels (tools/probes.cu) can hand it a row or column staged in shared
// memory, or the array in device memory, and the CPU tests
// (tests/test_torch_csrc_host.py) a host array.
//
// __host__ __device__ so that g++ builds the same code for those tests.
#pragma once
#include <stdint.h>

#define QZP_HASH_MUL 2654435761u

// -- gathers -----------------------------------------------------------------

// probe_inflate_step.py:dep_gather_loop, probe_pallas4.py:p_chain / p_tbl,
// probe_pallas.py:p_gather: idx = row[idx & mask] (take_along_axis on the
// lane axis; mask = the row's width - 1).
__host__ __device__ inline uint32_t qzp_dep_step(const uint32_t* row,
                                                 uint32_t idx, uint32_t mask) {
  return row[idx & mask];
}

// probe_inflate_step.py:indep_gather_loop: W gathers that depend only on
// idx, summed onto it, then masked.
template <int W>
__host__ __device__ inline uint32_t qzp_indep_step(const uint32_t* row,
                                                   uint32_t idx,
                                                   uint32_t mask) {
  uint32_t acc = idx;
  for (int w = 0; w < W; ++w)  // W is a constant: unrolled
    acc += row[(idx + (uint32_t)w) & mask];
  return acc & mask;
}

// probe_inflate_step5.py mk_subshuf (B), mk_onehot (C), mk_groupsel (C2):
// the lane's column of N entries (entry n at col[n * stride]);
// idx = (idx + col[idx & mask]) & post.
__host__ __device__ inline uint32_t qzp_column_step(const uint32_t* col,
                                                    int stride, uint32_t idx,
                                                    uint32_t mask,
                                                    uint32_t post) {
  return (idx + col[(idx & mask) * (uint32_t)stride]) & post;
}

// probe_pallas.py:p_walk: acc += x[acc % rows, i % cols] over an int32
// [rows, cols] tile, rows and cols powers of 2 (acc & (rows - 1) is the
// probe's floor modulo, for a negative acc too).
__host__ __device__ inline uint32_t qzp_walk_step(const uint32_t* x,
                                                  uint32_t rows, uint32_t cols,
                                                  uint32_t acc, uint32_t i) {
  return acc + x[(acc & (rows - 1u)) * cols + (i & (cols - 1u))];
}

// DEP's launch (qz_probe_dep): a thread an index, tx threads along a row
// of indexes (the row rounded up to a warp, at most QZP_DEP_THREADS), ty
// index rows a CTA (a one-row table: up to QZP_DEP_THREADS / tx), gx CTAs
// a row and gy along the rows.  A CTA of at most four warps keeps a row's
// random shared-memory lookups spread over SMs: 32 warps on one SM queue
// on its banks, and a lookup then costs their throughput, not one load's
// latency.  The gx CTAs of a row of indexes form a cluster, which stages
// their table row once between them (qzp_dep_stage); each cluster that
// shares a one-row table stages it once.  Rows of more than
// QZP_DEP_CLUSTER * QZP_DEP_THREADS indexes take wider CTAs, so that a
// cluster stays within the QZP_DEP_CLUSTER CTAs an H100 holds.
#define QZP_DEP_THREADS 128
#define QZP_DEP_CLUSTER 16

struct QzpDepPlan {
  int tx;
  int ty;
  int gx;
  int gy;
};

__host__ __device__ inline QzpDepPlan qzp_dep_plan(int rows, int cols,
                                                   int t_rows) {
  QzpDepPlan p;
  const int c32 = (cols + 31) & ~31;
  p.tx = c32 < QZP_DEP_THREADS ? c32 : QZP_DEP_THREADS;
  if (cols > QZP_DEP_CLUSTER * p.tx)
    p.tx = ((cols + QZP_DEP_CLUSTER - 1) / QZP_DEP_CLUSTER + 31) & ~31;
  p.gx = (cols + p.tx - 1) / p.tx;
  p.ty = t_rows == 1 ? QZP_DEP_THREADS / p.tx : 1;
  p.ty = p.ty < 1 ? 1 : p.ty < rows ? p.ty : rows;
  p.gy = (rows + p.ty - 1) / p.ty;
  return p;
}

// Thread i of the n threads of a cluster stages its share of a table row g
// of w words: 16-byte vectors i, i + n, ... where vec (w a multiple of 4,
// g 16-byte aligned), else words; every load once, handed to the sink,
// which stores it into the shared memory of each CTA of the cluster
// (sink.vec(v, a, b, c, d): words 4v .. 4v + 3; sink.word(c, a)).
template <class Sink>
__host__ __device__ inline void qzp_dep_stage(const uint32_t* g, int w,
                                              bool vec, int i, int n,
                                              const Sink& sink) {
  if (!vec) {
    for (int c = i; c < w; c += n) sink.word(c, g[c]);
    return;
  }
  for (int v = i; v < w / 4; v += n) {
#ifdef __CUDA_ARCH__
    const uint4 u = __ldg((const uint4*)g + v);
    sink.vec(v, u.x, u.y, u.z, u.w);
#else
    sink.vec(v, g[4 * v], g[4 * v + 1], g[4 * v + 2], g[4 * v + 3]);
#endif
  }
}

// -- register-only chains ----------------------------------------------------

// probe_inflate_step.py:elemwise_loop (its int32 body with 32-bit wrap)
__host__ __device__ inline uint32_t qzp_hash_step(uint32_t x) {
  const uint32_t v = (x * QZP_HASH_MUL + 12345u) & 0x7FFFFFFFu;
  return (v ^ (v >> 7)) & 0xFFFFu;
}

// probe_inflate_step5.py mk_ew (A), uint32
__host__ __device__ inline uint32_t qzp_ew_step(uint32_t x) {
  return (x * QZP_HASH_MUL) ^ (x >> 7);
}

// probe_pallas.py:p_double
__host__ __device__ inline uint32_t qzp_double_step(uint32_t x) {
  return x * 2u;
}

// -- decode-step skeletons ---------------------------------------------------

// probe_inflate_step3.py:step_loop, one element: its row's window word and
// tables are 128 int32 entries each, entry c at [c * stride].  Both levels
// of both lookups are loaded every step and a select keeps one: no branch.
__host__ __device__ inline void qzp_step3(const int32_t* win,
                                          const int32_t* tll,
                                          const int32_t* td, int stride,
                                          int32_t& bitpos, int32_t& acc) {
  const int wi = (bitpos >> 5) & 63;
  const uint32_t sh = (uint32_t)bitpos & 31u;
  const int32_t w0 = win[wi * stride];
  const int32_t w1 = win[((wi + 1) & 63) * stride];
  const int32_t bits = (int32_t)(((uint32_t)(w0 >> sh) |
                                  (((uint32_t)w1 << (31u - sh)) << 1)) &
                                 0x7FFFFFFFu);
  int32_t e = tll[(bits & 127) * stride];
  const int32_t e2 = tll[(((e >> 8) + (bits >> 9)) & 127) * stride];
  e = (e & 48) == 48 ? e2 : e;
  const int32_t clen = e & 15;
  const int32_t bits2 = (bits >> clen) & 0x3FFFFFF;
  int32_t ed = td[(bits2 & 127) * stride];
  const int32_t ed2 = td[(((ed >> 8) + (bits2 >> 9)) & 127) * stride];
  ed = (ed & 48) == 48 ? ed2 : ed;
  const int32_t adv = clen + (ed & 15) + 1;
  bitpos = (int32_t)((uint32_t)bitpos + (uint32_t)(adv & 31));
  acc ^= bits;
}

// The shape of a lane-major step: a window of W words, and litlen and
// distance tables of rc root cells then sc subtable cells, u16 entries two
// a u32 cell; rbits the root index bits (2 rc = 1 << rbits).  W, rc and sc
// are powers of 2.
struct QzpStep5 {
  int W;
  int rc;
  int sc;
  int rbits;
};

// (1 << n) - 1 for n < 32
__host__ __device__ inline uint32_t qzp_mask(uint32_t n) {
  return (1u << n) - 1u;
}

// (hi:lo) >> sh for sh < 32, the low word
__host__ __device__ inline uint32_t qzp_funnel(uint32_t lo, uint32_t hi,
                                               uint32_t sh) {
  return (lo >> sh) | ((hi << (31u - sh)) << 1);
}

// The fetch of mk_lane_major_step's "onehot" mode: entry idx mod n.
__host__ __device__ inline uint32_t qzp_fetch(const uint32_t* t, int stride,
                                              int32_t idx, int n) {
  return t[(uint32_t)(idx & (n - 1)) * (uint32_t)stride];
}

// The u16 entry of a cell pair index
__host__ __device__ inline uint32_t qzp_half(uint32_t cell, int32_t i) {
  return (cell >> (((uint32_t)i & 1u) << 4)) & 0xFFFFu;
}

// probe_inflate_step5.py:mk_lane_major_step ("onehot" mode), one lane:
// three window words, a root + subtable litlen resolve, RFC 1951's length
// closed form, a root + subtable distance resolve and its closed form, a
// token; branch-free.  win, tll and td are the lane's columns (entry r at
// [r * stride]).  Advances bitpos and returns the step's token.
__host__ __device__ inline uint32_t qzp_step5(const uint32_t* win,
                                              const uint32_t* tll,
                                              const uint32_t* td, int stride,
                                              const QzpStep5& p,
                                              int32_t& bitpos) {
  const uint32_t* tsub = tll + (int64_t)p.rc * stride;
  const uint32_t* dsub = td + (int64_t)p.rc * stride;
  int32_t wi = (bitpos >> 5) % (p.W - 2);  // the probe's floor modulo
  wi += wi < 0 ? p.W - 2 : 0;
  const uint32_t sh = (uint32_t)bitpos & 31u;
  const uint32_t w0 = qzp_fetch(win, stride, wi, p.W);
  const uint32_t w1 = qzp_fetch(win, stride, wi + 1, p.W);
  const uint32_t w2 = qzp_fetch(win, stride, wi + 2, p.W);
  const uint32_t b0 = qzp_funnel(w0, w1, sh);
  const uint32_t b1 = qzp_funnel(w1, w2, sh);
  // litlen: root, then subtable
  const int32_t idxr = (int32_t)(b0 & qzp_mask((uint32_t)p.rbits));
  uint32_t e = qzp_half(qzp_fetch(tll, stride, idxr >> 1, p.rc), idxr);
  const int32_t sidx = (int32_t)(((e >> 6) & 0xFFu) << 1) +
                       (int32_t)((b0 >> p.rbits) & qzp_mask(e & 15u));
  const uint32_t e2 = qzp_half(qzp_fetch(tsub, stride, sidx >> 1, p.sc), sidx);
  e = ((e >> 4) & 3u) == 3u ? e2 : e;
  const int32_t clen = (int32_t)(e & 15u);
  const int32_t kind = (int32_t)((e >> 4) & 3u);
  const int32_t sym = (int32_t)((e >> 6) & 0xFFu);
  int32_t e_len = (sym - 4 > 0 ? sym - 4 : 0) >> 2;
  e_len = e_len < 5 ? e_len : 5;
  int32_t lbase = sym < 4 ? sym + 3 : ((4 + (sym & 3)) << e_len) + 3;
  e_len = sym >= 28 ? 0 : e_len;
  lbase = sym >= 28 ? 258 : lbase;
  const int32_t eb = kind == 1 ? e_len : 0;
  const int32_t lex = (int32_t)((b0 >> clen) & qzp_mask((uint32_t)eb));
  const int32_t mlen = lbase + lex;
  const int32_t used1 = clen + eb;
  const uint32_t bits2 = qzp_funnel(b0, b1, (uint32_t)used1);
  // distance: root, then subtable
  const int32_t didx = (int32_t)(bits2 & qzp_mask((uint32_t)p.rbits));
  uint32_t ed = qzp_half(qzp_fetch(td, stride, didx >> 1, p.rc), didx);
  const int32_t dsidx = (int32_t)(((ed >> 6) & 0xFFu) << 1) +
                        (int32_t)((bits2 >> p.rbits) & qzp_mask(ed & 15u));
  const uint32_t ed2 =
      qzp_half(qzp_fetch(dsub, stride, dsidx >> 1, p.sc), dsidx);
  ed = ((ed >> 4) & 3u) == 3u ? ed2 : ed;
  const int32_t dclen = (int32_t)(ed & 15u);
  const int32_t ds = (int32_t)((ed >> 6) & 31u);
  const int32_t e_d = (ds - 2 > 0 ? ds - 2 : 0) >> 1;
  const int32_t dbase1 = ds < 4 ? ds : (2 + (ds & 1)) << e_d;
  const int32_t deb = ds < 4 ? 0 : e_d;
  const int32_t dex = (int32_t)((bits2 >> dclen) & qzp_mask((uint32_t)deb));
  const int32_t dist1 = dbase1 + dex;
  const int32_t adv = used1 + (kind == 1 ? dclen + deb : 0);
  const uint32_t tok = 2u | ((uint32_t)mlen << 2) | ((uint32_t)dist1 << 11);
  bitpos = (int32_t)((uint32_t)bitpos + (uint32_t)(adv & 15) + (tok & 1u));
  return tok;
}

// -- bitonic network over segments -------------------------------------------

// Segment s's element i lies at s * seg_stride + i * elem_stride of a tile:
// rows of [S, L] (seg_stride L, elem_stride 1), columns (1, L), or the
// whole tile (0, 1).
struct QzpSegments {
  uint32_t n;  // elements a segment, a power of 2
  uint32_t seg_stride;
  uint32_t elem_stride;
};

// log2 of a power of 2
__host__ __device__ inline uint32_t qzp_log2(uint32_t x) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__ffs((int)x) - 1u;
#else
  return (uint32_t)__builtin_ctz(x);
#endif
}

// Pair p (of the tile's nseg * n / 2) of network stage (k, j): the places
// of its lower and upper element, and whether it orders them ascending.
// Every count is a power of 2: shifts and masks, no division.
__host__ __device__ inline void qzp_bitonic_pair(const QzpSegments& g,
                                                 uint32_t p, uint32_t k,
                                                 uint32_t j, uint32_t* lo,
                                                 uint32_t* hi, bool* asc) {
  const uint32_t half = g.n >> 1;
  const uint32_t s = p >> qzp_log2(half), q = p & (half - 1u);
  const uint32_t i = ((q & ~(j - 1u)) << 1) | (q & (j - 1u));  // bit j clear
  *lo = s * g.seg_stride + i * g.elem_stride;
  *hi = s * g.seg_stride + (i + j) * g.elem_stride;
  *asc = (i & k) == 0u;
}

// One compare-exchange of int32 values in place
__host__ __device__ inline void qzp_compare_exchange(int32_t* x, uint32_t lo,
                                                     uint32_t hi, bool asc) {
  const int32_t a = x[lo], b = x[hi];
  if ((a > b) == asc) {
    x[lo] = b;
    x[hi] = a;
  }
}

// -- TRANSPOSE over a thread-block cluster ----------------------------------

// probe_inflate_step5.py:mk_transpose, K times x = x.T + 1 of an [n, n]
// tile (4 <= n <= 128 a power of 2), cut into blocks of b = min(n, 32)
// words a side, nb = n / b blocks a side, one block a CTA of a cluster of
// nb * nb CTAs: CTA q owns block (q / nb, q % nb).  A CTA keeps two
// buffers of b rows of stride = b + 4 words (so that a warp's 16-byte
// stores of column c at rows 4w fall on 32 distinct banks); its threads
// move 4 words (16 bytes) at once and cover the block's b * b / 4
// vectors, at least a warp.
struct QzpTrPlan {
  int b;
  int nb;
  int ctas;
  int stride;
  int threads;
};

__host__ __device__ inline QzpTrPlan qzp_tr_plan(int n) {
  QzpTrPlan p;
  p.b = n < 32 ? n : 32;
  p.nb = n / p.b;
  p.ctas = p.nb * p.nb;
  p.stride = p.b + 4;
  p.threads = p.b * p.b / 4;
  p.threads = p.threads < 32 ? 32 : p.threads;
  return p;
}

// The CTA that owns block (j, i) of CTA q's block (i, j): where q's block,
// transposed, goes.  A diagonal CTA is its own partner.
__host__ __device__ inline int qzp_tr_partner(int q, int nb) {
  return (q % nb) * nb + q / nb;
}

// The word of the [n, n] tile at row r, column c of CTA q's block
__host__ __device__ inline int qzp_tr_global(const QzpTrPlan& p, int n, int q,
                                             int r, int c) {
  return ((q / p.nb) * p.b + r) * n + (q % p.nb) * p.b + c;
}

// Thread t's share of one step: column c of its own buffer's rows r0 ..
// r0 + 3, each + 1, into v; returns where they go in the partner's
// buffer, as 4 consecutive words (row c, from column r0), or -1 for a
// thread past the block.  Thread t takes vector t of the block's
// b * b / 4; a warp reads 32 consecutive columns of a row at a time.
__host__ __device__ inline int qzp_tr_gather(const QzpTrPlan& p, int t,
                                             const uint32_t* src,
                                             uint32_t* v) {
  const int c = t % p.b, r0 = t / p.b * 4;
  if (r0 >= p.b) return -1;
  for (int e = 0; e < 4; ++e) v[e] = src[(r0 + e) * p.stride + c] + 1u;
  return c * p.stride + r0;
}

// -- ROLL and REFILL ---------------------------------------------------------

// probe_pallas3.py:pallas_roll on the row axis: output row r of a tile of
// rows rows is input row (r - shift) mod rows, shift in [0, rows); one
// compare a row, no division.
__host__ __device__ inline int qzp_roll_src_row(int r, int shift, int rows) {
  const int s = r - shift;
  return s < 0 ? s + rows : s;
}

// The row roll's launch: a thread a vector of vec words (4: 16 bytes, or 1),
// vpr threads a row (threadIdx.x), rpc rows a CTA (threadIdx.y) so that a
// CTA holds up to 256 threads, blocks CTAs for the tile.
struct QzpRollPlan {
  int vpr;
  int rpc;
  int blocks;
};

__host__ __device__ inline QzpRollPlan qzp_roll_rows_plan(int rows, int cols,
                                                          int vec) {
  QzpRollPlan p;
  p.vpr = cols / vec;
  p.rpc = 256 / p.vpr;
  p.rpc = p.rpc < 1 ? 1 : p.rpc > rows ? rows : p.rpc;
  p.blocks = (rows + p.rpc - 1) / p.rpc;
  return p;
}

// ROLL on the lane axis of a 128-word row held 4 words a thread by a warp:
// output word 4t + j is input word (4t + j - shift) & 127, which thread
// `lane` holds as its word `word` = (j - shift) & 3, the same word for every
// thread (so one __shfl_sync moves it).
struct QzpLaneSrc {
  int lane;
  int word;
};

__host__ __device__ inline QzpLaneSrc qzp_roll_lane_src(int t, int j,
                                                        int shift) {
  QzpLaneSrc s;
  s.lane = ((4 * t + j - shift) & 127) >> 2;
  s.word = (j - shift) & 3;
  return s;
}

// The lane roll's launch: a warp a row, up to 32 rows a CTA.
__host__ __device__ inline int qzp_roll_lanes_warps(int rows) {
  return rows < 32 ? rows : 32;
}

// REFILL k of a lane starts at word off, plus alt on odd refills.
__host__ __device__ inline int qzp_refill_at(int off, int k, int alt) {
  return off + (k & 1) * alt;
}

// The 16-byte-aligned span around a window of win words at word o of a row
// whose words 4i start 16-byte vectors: nvec vectors from word base, the
// window head words into them.  base + 4 nvec <= the window's end rounded
// up to 4 words, so the span stays in a row of a multiple of 4 words.
struct QzpSpan {
  int base;
  int head;
  int nvec;
};

__host__ __device__ inline QzpSpan qzp_refill_span(int o, int win) {
  QzpSpan s;
  s.base = o & ~3;
  s.head = o & 3;
  s.nvec = (s.head + win + 3) >> 2;
  return s;
}
