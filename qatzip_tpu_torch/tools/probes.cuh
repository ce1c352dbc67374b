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

// log2 of a power of 2
__host__ __device__ constexpr int qzp_lg(int x) {
  return x <= 1 ? 0 : 1 + qzp_lg(x >> 1);
}

// -- gathers -----------------------------------------------------------------

// probe_inflate_step.py:dep_gather_loop, probe_pallas4.py:p_chain / p_tbl,
// probe_pallas.py:p_gather: idx = row[idx & mask] (take_along_axis on the
// lane axis; mask = the row's width - 1).
__host__ __device__ inline uint32_t qzp_dep_step(const uint32_t* row,
                                                 uint32_t idx, uint32_t mask) {
  return row[idx & mask];
}

// probe_inflate_step.py:indep_gather_loop over a row staged for INDEP
// (qz_probe_indep): its w words (a power of 2) R times over, word i's copy
// c at word i R + c, and its first words again past its end up to w + W -
// 1 (word w + i = word i).  Lane l reads copy l % R, so that every load of
// a warp falls on bank l at R = 32, and at most 32 / R lanes share a bank
// below that, whatever the indexes.  As the tail wraps, (v + x) & (w - 1)
// is (v & (w - 1)) + x for x < W: a step takes one AND-OR for its address
// and loads its W words at immediate offsets x R 4 bytes from there.  The
// sum is carried unmasked from step to step (the low bits of a sum depend
// only on the low bits of its terms) and masked once, after the last step.
// R is the largest power of 2 up to 32 whose (w + W - 1) R words fit in a
// CTA's shared memory; 0 where none does.
#define QZP_INDEP_MAX_R 32

__host__ __device__ inline int qzp_indep_words(int w, int W) {
  return w + W - 1;
}

__host__ __device__ inline int qzp_indep_r(int w, int W, int smem_bytes) {
  for (int r = QZP_INDEP_MAX_R; r >= 1; r >>= 1)
    if ((long long)qzp_indep_words(w, W) * r * 4 <= smem_bytes) return r;
  return 0;
}

// The staging: thread t of n takes staged words t, t + n, .. (each row
// word (i % w) once, and each wrapped word again), loads it and stores its
// R copies in units of V = min(R, 4) (a 16-byte store where R >= 4), unit
// q of its R / V at (q + t) % (R / V) first, so that the 16-byte stores of
// a quarter warp, 8 threads, fall on distinct banks.
template <int R>
__host__ __device__ constexpr int qzp_indep_v() {
  return R < 4 ? R : 4;
}

// The staged word of unit j (of R / V) of thread t's word i
template <int R>
__host__ __device__ inline int qzp_indep_unit_at(int i, int j, int t) {
  constexpr int U = R / qzp_indep_v<R>();
  return i * R + ((j + t) & (U - 1)) * qzp_indep_v<R>();
}

// The INDEP sums run shifted left by S = log2(4 R), a staged word's bytes:
// the lane's sum u = v << S, and every staged copy of row[i] is row[i] <<
// S (exact on the low log2(w) + S <= 32 bits the mask keeps).
template <int R>
__host__ __device__ constexpr int qzp_indep_shift() {
  return qzp_lg(4 * R);
}

// One INDEP step of a lane: ms = (w - 1) << S, lane = 4 (l % R) the lane's
// copy's bytes.  Its W words sit at byte offsets ((u & ms) | lane) + 4 R x
// of the staged row (one AND-OR), read through ld (a 4-byte load at a byte
// offset), and go onto u unshifted: three-way adds in the order the loads
// arrive, one after the last.
template <int W, int R, class Rd>
__host__ __device__ inline uint32_t qzp_indep_step(uint32_t lane, uint32_t u,
                                                   uint32_t ms,
                                                   const Rd& ld) {
  const uint32_t off = (u & ms) | lane;
  uint32_t s[W];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int x = 0; x < W; ++x) s[x] = ld(off + (uint32_t)(x * R * 4));
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int x = 0; x < W; ++x) u += s[x];
  return u;
}

// -- staging: every load of a CTA in flight ----------------------------------
//
// A probe stages its tables into shared memory as `items` 16-byte vectors:
// thread t of the CTA's n takes items t, t + n, ... (at most PER of them),
// issues all its loads, then makes its stores, so that no store waits for
// a load but its own and the loads of a thread overlap.  STEP3's and
// TOKENS' CTAs (qzp_row_plan) stage with QZP_STAGE_THREADS threads, those
// beyond the lanes only staging, or, for the TOKENS tile, with its lanes
// and at most QZP_STAGE_PER loads each; STEP5's plan is QzpS5Plan.
#define QZP_STAGE_THREADS 128
#define QZP_STAGE_PER 8

// ld(i, v) loads item i's V words into v, st(i, v) stores them
template <int PER, int V, class Ld, class St>
__host__ __device__ inline void qzp_stage(int t, int n, int items,
                                          const Ld& ld, const St& st) {
  uint32_t v[PER][V];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int j = 0; j < PER; ++j) {
    const int i = t + j * n;
    if (i < items) ld(i, v[j]);
  }
#ifdef __CUDA_ARCH__
  // no store moves up between the loads (the compiler would otherwise
  // merge each store into its load's branch: a store waits for its load)
  asm volatile("" ::: "memory");
#endif
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int j = 0; j < PER; ++j) {
    const int i = t + j * n;
    if (i < items) st(i, v[j]);
  }
}

struct QzpStagePlan {
  int threads;  // the CTA's
  int per;      // the most loads a thread issues
};

// COLUMN (qz_probe_column): a CTA a block of 32 columns (lanes) of the
// [n, cols] table and every row of the [rows, cols] indexes (rows <= 32),
// a thread an index; the block staged [n][32] (a row of 128 bytes, lane l
// at byte 4 l, so that a warp's 32 lanes read 32 banks whatever their
// rows) by 2-D bulk tensor copies: box b, rows b * box .. b * box + box -
// 1 of the block, at shared-memory word 32 b box (a box holds at most 256
// rows).  On an H100 that was no slower from a graph than the block staged
// by 16-byte loads with qzp_stage (at least 128 threads, 8 loads a thread:
// 0-0.0002 ms slower of 0.0022-0.0027), and index rows split over several
// CTAs a block, each staging it, were no faster.
#define QZP_COL_MAX_N 1024   // 128 KB staged
#define QZP_COL_BOX 256      // a tensor copy's box: at most 256 rows

__host__ __device__ inline int qzp_col_box(int n) {
  return n < QZP_COL_BOX ? n : QZP_COL_BOX;
}

__host__ __device__ inline int qzp_col_boxes(int n) {
  return (n + qzp_col_box(n) - 1) / qzp_col_box(n);
}

// One COLUMN step of a lane (toff = 4 lane) over its block staged at byte
// address base, read through ld (a 4-byte load at a byte address).  The
// probe's idx_k is v & post for a post of the form 2^p - 1 that covers the
// rows' mask m (post >= n - 1): the low p bits of a sum depend only on
// the low p bits of its terms, so v carries the sums unmasked and is
// masked once, after the last step.  w = v << 7 carries the same sums
// shifted by a row's bytes, so the row's address is one AND-OR, (w & m7)
// | toff with m7 = m << 7, and the sum onto w one shift-add: the chain a
// step is the load and two integer instructions.
template <class Rd>
__host__ __device__ inline void qzp_col_step(uint32_t base, uint32_t toff,
                                             uint32_t m7, uint32_t& v,
                                             uint32_t& w, const Rd& ld) {
  const uint32_t g = ld(base + ((w & m7) | toff));
  v += g;
  w += g << 7;
}

// STEP3 and TOKENS (qzp_step): a CTA's lpc lanes (lpc <= 128) share one
// row of the [R, 128] arrays.  Item i is vector i % 32 of array FIRST +
// i / 32 of that row (win, tll, td: STEP3 stages all three, FIRST 0;
// TOKENS tll alone, FIRST 1), stored at shared-memory word 128 FIRST + 4 i.
// A CTA of lanes that pass a barrier a flush (TOKENS' tile) stages with its
// lanes alone, else with QZP_STAGE_THREADS threads.
__host__ __device__ inline int qzp_row_items(bool step3) {
  return step3 ? 96 : 32;
}

__host__ __device__ inline QzpStagePlan qzp_row_plan(bool step3, bool tile,
                                                     int lpc) {
  QzpStagePlan p;
  p.threads = tile ? lpc : QZP_STAGE_THREADS;
  p.per = (qzp_row_items(step3) + p.threads - 1) / p.threads;
  return p;
}

// the loads a staging thread of qzp_step is built for: one in a CTA of 128
// threads, QZP_STAGE_PER in the tile's CTA of lpc >= 4 threads
__host__ __device__ constexpr int qzp_row_per(bool tile) {
  return tile ? QZP_STAGE_PER : 1;
}

struct QzpRowItem {
  int array;  // 0 win, 1 tll, 2 td
  int vec;    // the 16-byte vector of its row
};

__host__ __device__ inline QzpRowItem qzp_row_item(int i, int first) {
  QzpRowItem it;
  it.array = first + (i >> 5);
  it.vec = i & 31;
  return it;
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

// -- STEP5: the lane-major step over widened entries ---------------------------
//
// probe_inflate_step5.py:mk_lane_major_step ("onehot" mode), one lane: three
// window words, a root + subtable litlen resolve, RFC 1951's length closed
// form, a root + subtable distance resolve and its closed form, a token;
// branch-free.  The lane's window and tables arrive as columns of u32 words
// (win [W, lanes], tll and td [rc + sc, lanes]: rc root cells, then sc
// subtable cells, u16 entries two a cell).  The kernel stages its lanes'
// columns into shared memory and rewrites the tables on the way, so that a
// step derives nothing from an entry that the staging could derive:
//   * a root half becomes a 32-bit word of its own (qzp_s5_root): a
//     subtable pointer as its subtable base and index mask, any other entry
//     as bit 31 over its fields re-encoded in 16 bits;
//   * a subtable cell keeps its two halves, each re-encoded in 16 bits
//     (qzp_s5_lit16, qzp_s5_dist16): the bits the entry consumes in bits
//     0-4, so that the next funnel shift takes the entry itself, and the
//     closed forms' bases and extra bits after them.
// The shapes are compile-time (QzpS5Shape): the floor modulo of the window
// index is a multiply-high, every mask a constant.

// (1 << n) - 1 for n < 32
__host__ __device__ inline uint32_t qzp_mask(uint32_t n) {
  return (1u << n) - 1u;
}

// (hi:lo) >> (sh & 31), the low word (a funnel shift)
__host__ __device__ inline uint32_t qzp_funnel(uint32_t lo, uint32_t hi,
                                               uint32_t sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  sh &= 31u;
  return (lo >> sh) | ((hi << (31u - sh)) << 1);
#endif
}

// A step's shape: a window of W words, rc root cells and sc subtable cells
// a table (powers of 2; 2 rc = 1 << RBITS).  A lane's column in shared
// memory holds, a row of LPC words each (lane t of its CTA at word t):
// the window, the litlen roots (2 rc widened words), the litlen subtable
// (sc cells), the distance roots, the distance subtable.
template <int W_, int RC_, int SC_>
struct QzpS5Shape {
  static constexpr int W = W_, RC = RC_, SC = SC_, RBITS = qzp_lg(2 * RC_);
  static constexpr int LROOT = W, LSUB = LROOT + 2 * RC, DROOT = LSUB + SC,
                       DSUB = DROOT + 2 * RC, ROWS = DSUB + SC;
  static constexpr int SRC_ROWS = W + 2 * (RC + SC);   // win, tll, td
  // a multiple of W - 2 above 2^26, so that (bitpos >> 5) + BIAS is the
  // probe's floor modulo's dividend made non-negative (and below 2^28)
  static constexpr uint32_t BIAS =
      ((1u << 26) + (uint32_t)W - 3u) / (uint32_t)(W - 2) * (uint32_t)(W - 2);
  // x / (W - 2) = mulhi(x, MAGIC) >> MSHIFT for every x < 2^28: MAGIC =
  // ceil(2^(32 + MSHIFT) / (W - 2)) exceeds the quotient by less than
  // 2^(4 + MSHIFT) / (W - 2)
  static constexpr int MSHIFT = qzp_lg(W - 2);
  static constexpr uint64_t MAGIC =
      ((uint64_t)1 << (32 + MSHIFT)) / (uint64_t)(W - 2) + 1u;
  static_assert(MAGIC < ((uint64_t)1 << 32) &&
                    MAGIC * (uint64_t)(W - 2) - ((uint64_t)1 << (32 + MSHIFT)) <
                        ((uint64_t)1 << (4 + MSHIFT)),
                "the window index's divisor");
};

// The shapes the kernels are built for: the TPU probe's root of 128 cells
// and the inflate's 256, a 128-word window and 256 subtable cells.
using QzpS5R128 = QzpS5Shape<128, 128, 256>;
using QzpS5R256 = QzpS5Shape<128, 256, 256>;

template <int N>
struct QzpInt {
  static constexpr int value = N;
};

// f(Sh{}, QzpInt<LPC>{}) for the shape and lanes a CTA (1, 8 or 32: the
// probe's cases) the kernels are built for; -1 for any other.
template <class Sh, class F>
inline int qzp_s5_lpc(int lpc, F& f) {
  switch (lpc) {
    case 1: return f(Sh{}, QzpInt<1>{});
    case 8: return f(Sh{}, QzpInt<8>{});
    case 32: return f(Sh{}, QzpInt<32>{});
  }
  return -1;
}

template <class F>
inline int qzp_s5_dispatch(int W, int rc, int sc, int lpc, F f) {
  if (W != 128 || sc != 256) return -1;
  if (rc == 128) return qzp_s5_lpc<QzpS5R128>(lpc, f);
  if (rc == 256) return qzp_s5_lpc<QzpS5R256>(lpc, f);
  return -1;
}

// A litlen half h (clen bits 0-3, kind 4-5, symbol 6-13) re-encoded: used1
// = clen + the length's extra bits (bits 0-4), eb + 1 for a length (kind
// 1; else 0, bits 5-7), lbase - 3 (bits 8-15; 258 for symbols from 28).
__host__ __device__ inline uint32_t qzp_s5_lit16(uint32_t h) {
  const uint32_t clen = h & 15u, kind = (h >> 4) & 3u, sym = (h >> 6) & 0xFFu;
  uint32_t e_len = sym > 4u ? (sym - 4u) >> 2 : 0u;
  e_len = e_len < 5u ? e_len : 5u;
  uint32_t lbase = sym < 4u ? sym + 3u : ((4u + (sym & 3u)) << e_len) + 3u;
  e_len = sym >= 28u ? 0u : e_len;
  lbase = sym >= 28u ? 258u : lbase;
  const uint32_t eb = kind == 1u ? e_len : 0u;
  return (clen + eb) | ((kind == 1u ? e_len + 1u : 0u) << 5) |
         ((lbase - 3u) << 8);
}

// A distance half re-encoded: dclen + deb (bits 0-4), deb (5-8), the
// symbol (9-13).
__host__ __device__ inline uint32_t qzp_s5_dist16(uint32_t h) {
  const uint32_t ds = (h >> 6) & 31u;
  const uint32_t deb = ds < 4u ? 0u : (ds - 2u) >> 1;
  return ((h & 15u) + deb) | (deb << 5) | (ds << 9);
}

// A root half widened: a subtable pointer (kind 3) as its subtable base
// ((h >> 6) & 0xFF) << 1 from bit 16 + sh and the low 9 bits of its index
// mask (1 << clen) - 1 from bit sh, bit 31 clear (sh <= 6); any other
// entry as bit 31 over fin16, its re-encoded fields.  A subtable of 256
// cells takes only the low 9 bits of an index (cell and half), and the
// step wants them shifted by sh (qzp_s5_resolve).
__host__ __device__ inline uint32_t qzp_s5_root(uint32_t h, uint32_t fin16,
                                               uint32_t sh) {
  return ((h >> 4) & 3u) == 3u
             ? ((((h >> 6) & 0xFFu) << 17) | (qzp_mask(h & 15u) & 0x1FFu))
                   << sh
             : 0x80000000u | fin16;
}

// A subtable cell with both halves re-encoded
__host__ __device__ inline uint32_t qzp_s5_cell(uint32_t cell, bool lit) {
  const uint32_t lo = cell & 0xFFFFu, hi = cell >> 16;
  return lit ? qzp_s5_lit16(lo) | (qzp_s5_lit16(hi) << 16)
             : qzp_s5_dist16(lo) | (qzp_s5_dist16(hi) << 16);
}

// The match length of a resolved litlen entry e (its re-encoded fields in
// bits 0-15) over the stream bits b0
__host__ __device__ inline uint32_t qzp_s5_mlen(uint32_t e, uint32_t b0) {
  const uint32_t ebp = (e >> 5) & 7u;
  const uint32_t eb = ebp - (ebp != 0u ? 1u : 0u);
  return ((e >> 8) & 0xFFu) + 3u +
         ((b0 >> ((e & 31u) - eb)) & qzp_mask(eb));
}

// The distance + 1 of a resolved distance entry ed over the bits after the
// length
__host__ __device__ inline uint32_t qzp_s5_dist1(uint32_t ed, uint32_t bits2) {
  const uint32_t deb = (ed >> 5) & 15u, ds = (ed >> 9) & 31u;
  const uint32_t dbase1 = ds < 4u ? ds : (2u + (ds & 1u)) << ((ds - 2u) >> 1);
  return dbase1 + ((bits2 >> ((ed & 31u) - deb)) & qzp_mask(deb));
}

// The bits a step consumes, before the probe's & 15: the litlen entry's,
// and the distance's after a length
__host__ __device__ inline uint32_t qzp_s5_adv(uint32_t e, uint32_t ed) {
  return (e & 31u) + (((e >> 5) & 7u) != 0u ? ed & 31u : 0u);
}

// (a * b) >> 32
__host__ __device__ inline uint32_t qzp_mulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// A root + subtable resolve over bits through ld (a 4-byte shared-memory
// load at a byte address): the root's widened word, then the subtable cell
// it points at, whose half the pointer's low index bit picks; the root
// word itself where it is no pointer.  The lane's word of row r of the
// CTA's shared memory lies at base + (r << ROW | toff) (rows of S words,
// the lane's toff = 4 t), root and sub the tables' first rows.  The
// pointer's fields come shifted by ROW - 1 (qzp_s5_root), so that the sum
// is the subtable index shifted so, whose cell bits mask straight into an
// address; bits above the index's 9 may carry junk.  For an entry that is
// no pointer the subtable load reads a cell the select then drops.
template <class Sh, int S, class Rd>
__host__ __device__ inline uint32_t qzp_s5_resolve(uint32_t base,
                                                   uint32_t toff, int root,
                                                   int sub, uint32_t bits,
                                                   const Rd& ld) {
  constexpr uint32_t ROW = qzp_lg(S) + 2;   // log2 of a row's bytes
  static_assert(Sh::SC == 256, "the widened pointer keeps 9 index bits");
  const uint32_t r = ld(base + (uint32_t)(root << ROW) +
                        (((bits << ROW) & ((2u * Sh::RC - 1u) << ROW)) | toff));
  // the index bits above the root's, at bit ROW - 1 on (the root's own
  // below them meet the pointer's clear low bits), beside the load
  const uint32_t hi = bits >> (Sh::RBITS - (ROW - 1));
  const uint32_t s = (r >> 16) + (hi & r);
  const uint32_t cell = ld(base + (uint32_t)(sub << ROW) +
                           ((s & ((Sh::SC - 1u) << ROW)) | toff));
  return (int32_t)r < 0 ? r : cell >> (((s >> (ROW - 1)) & 1u) << 4);
}

// One step of lane t (toff = 4 t) of a CTA whose shared memory starts at
// byte address base: advances bitpos and returns the token.  Five
// dependent levels of loads: the three window words, the litlen root, its
// subtable, the distance root, its subtable.  Every address is the CTA's
// base, a constant row the load takes as its offset, and a shifted index
// with the lane's bits.
template <class Sh, int S, class Rd>
__host__ __device__ inline uint32_t qzp_s5_step(uint32_t base, uint32_t toff,
                                                int32_t& bitpos,
                                                const Rd& ld) {
  constexpr uint32_t ROW = qzp_lg(S) + 2;
  const uint32_t x = (uint32_t)(bitpos >> 5) + Sh::BIAS;
  const uint32_t q = qzp_mulhi(x, (uint32_t)Sh::MAGIC) >> Sh::MSHIFT;
  const uint32_t sh = (uint32_t)bitpos & 31u;
  // the row x % (W - 2), as (x << ROW) - (q (W - 2) << ROW) mod 2^32
  const uint32_t w =
      base + (((x << ROW) | toff) - ((q * (uint32_t)(Sh::W - 2)) << ROW));
  const uint32_t w0 = ld(w), w1 = ld(w + (1u << ROW)),
                 w2 = ld(w + (2u << ROW));
  const uint32_t b0 = qzp_funnel(w0, w1, sh), b1 = qzp_funnel(w1, w2, sh);
  const uint32_t e =
      qzp_s5_resolve<Sh, S>(base, toff, Sh::LROOT, Sh::LSUB, b0, ld);
  const uint32_t bits2 = qzp_funnel(b0, b1, e);   // by used1, e's bits 0-4
  const uint32_t ed =
      qzp_s5_resolve<Sh, S>(base, toff, Sh::DROOT, Sh::DSUB, bits2, ld);
  const uint32_t tok =
      2u | (qzp_s5_mlen(e, b0) << 2) | (qzp_s5_dist1(ed, bits2) << 11);
  bitpos = (int32_t)((uint32_t)bitpos + (qzp_s5_adv(e, ed) & 15u) +
                     (tok & 1u));
  return tok;
}

// The staging of a CTA of LPC lanes: THREADS threads (at least 128; only
// the first LPC then run a lane each) load the CTA's lanes' words of every
// source row, VEC words at once (16 bytes where LPC >= 4, along the row of
// lanes).  Item i is vector i % VPR of source row i / VPR; thread t takes
// items t, t + THREADS, ... (PER of them) and issues all its loads before
// its first store.  THREADS grows with LPC so that PER stays at most
// SRC_ROWS / 128 rounded up (9).
template <class Sh, int LPC>
struct QzpS5Plan {
  static constexpr int VEC = LPC >= 4 ? 4 : 1;
  static constexpr int VPR = LPC / VEC;
  static constexpr int ITEMS = Sh::SRC_ROWS * VPR;
  static constexpr int THREADS = VEC == 4 ? 128 * VPR : 128;
  static constexpr int PER = (ITEMS + THREADS - 1) / THREADS;
  static constexpr int BYTES = Sh::ROWS * LPC * 4;   // shared memory
};

// Item i: its source (0 win, 1 tll, 2 td), its row there, the first of its
// lanes in the CTA
struct QzpS5Item {
  int src;
  int row;
  int c;
};

template <class Sh, int LPC>
__host__ __device__ inline QzpS5Item qzp_s5_item(int i) {
  using P = QzpS5Plan<Sh, LPC>;
  const int r = i / P::VPR;
  QzpS5Item it;
  it.c = (i % P::VPR) * P::VEC;
  it.src = r < Sh::W ? 0 : r < Sh::W + Sh::RC + Sh::SC ? 1 : 2;
  it.row = it.src == 0 ? r
           : it.src == 1 ? r - Sh::W
                         : r - Sh::W - Sh::RC - Sh::SC;
  return it;
}

// Stores item it's loaded words v through st.put<VEC>(word, v) (VEC words
// from shared-memory word `word`): a window vector as it is, a root cell's as
// two widened vectors (rows 2q and 2q + 1 of its roots), a subtable
// cell's re-encoded.
template <class Sh, int LPC, class St>
__host__ __device__ inline void qzp_s5_put(const QzpS5Item& it,
                                           const uint32_t* v, const St& st) {
  constexpr int V = QzpS5Plan<Sh, LPC>::VEC;
  if (it.src == 0) {
    st.template put<V>(it.row * LPC + it.c, v);
    return;
  }
  const bool lit = it.src == 1;
  uint32_t a[V], b[V];
  if (it.row < Sh::RC) {
    constexpr uint32_t SH = qzp_lg(LPC) + 1;   // a row's bytes' log2 - 1
    for (int j = 0; j < V; ++j) {
      const uint32_t lo = v[j] & 0xFFFFu, hi = v[j] >> 16;
      a[j] = qzp_s5_root(lo, lit ? qzp_s5_lit16(lo) : qzp_s5_dist16(lo), SH);
      b[j] = qzp_s5_root(hi, lit ? qzp_s5_lit16(hi) : qzp_s5_dist16(hi), SH);
    }
    const int row = (lit ? Sh::LROOT : Sh::DROOT) + 2 * it.row;
    st.template put<V>(row * LPC + it.c, a);
    st.template put<V>((row + 1) * LPC + it.c, b);
    return;
  }
  for (int j = 0; j < V; ++j) a[j] = qzp_s5_cell(v[j], lit);
  st.template put<V>(((lit ? Sh::LSUB : Sh::DSUB) + it.row - Sh::RC) * LPC +
                         it.c,
                     a);
}

template <class Sh, int LPC, class Ld>
struct QzpS5ItemLoad {
  const Ld& ld;
  template <int V>
  __host__ __device__ void operator()(int i, uint32_t (&v)[V]) const {
    ld(qzp_s5_item<Sh, LPC>(i), v);
  }
};

template <class Sh, int LPC, class St>
struct QzpS5ItemPut {
  const St& st;
  __host__ __device__ void operator()(int i, const uint32_t* v) const {
    qzp_s5_put<Sh, LPC>(qzp_s5_item<Sh, LPC>(i), v, st);
  }
};

// Thread t's share of the staging (qzp_stage): its PER loads through
// ld(item, words), then its stores through st.
template <class Sh, int LPC, class Ld, class St>
__host__ __device__ inline void qzp_s5_stage(int t, const Ld& ld,
                                             const St& st) {
  using P = QzpS5Plan<Sh, LPC>;
  qzp_stage<P::PER, P::VEC>(t, P::THREADS, P::ITEMS,
                            QzpS5ItemLoad<Sh, LPC, Ld>{ld},
                            QzpS5ItemPut<Sh, LPC, St>{st});
}

// -- TOKENS: a token a step, through a double-buffered tile -------------------

// probe_inflate_step4.py:tokens_dma, one lane's step over its row's
// 128-word table: the token, and idx advanced by it
__host__ __device__ inline uint32_t qzp_tok_step(const uint32_t* t,
                                                 int32_t& idx) {
  const uint32_t v = t[(uint32_t)idx & 127u];
  idx = (int32_t)((uint32_t)idx + v);
  return v;
}

#define QZP_MAX_SMEM (227 * 1024)
#define QZP_TOK_STAGED 384   // the words staged before the token buffers

// The rows of each of the two token buffers ([rows][lpc] words each, after
// the staged words): the tile where both fit in a CTA's shared memory and
// a bulk tensor copy's box (at most 256 rows), else the largest divisor of
// the tile that does (a buffer is flushed when full, so K % tile == 0
// keeps every flush whole).
__host__ __device__ inline int qzp_tok_rows(int tile, int lpc) {
  for (int d = 1; d <= tile; ++d)
    if (tile % d == 0 && tile / d <= 256 &&
        (QZP_TOK_STAGED + 2 * (tile / d) * lpc) * 4 <= QZP_MAX_SMEM)
      return tile / d;
  return 0;
}

// The buffer step k writes, and its row there
__host__ __device__ inline int qzp_tok_buffer(int k, int rows) {
  return (k / rows) & 1;
}

// -- BITONIC: the network over a tile's segments ----------------------------
//
// probe_pallas3.py p_bitonic / p_rows / p_cols: each segment of m elements
// of an int32 tile of n (both powers of 2) sorted ascending by the TPU
// kernels' network: for k = 2, 4, .. m and j = k / 2, .. 1, stage (k, j)
// pairs index i of a segment with i ^ j, the smaller first where i & k is
// 0.  Segment s's index i lies at s * seg_stride + i * elem_stride of the
// tile: rows of [S, L] (L, 1), columns (1, L), the whole tile (0, 1).
//
// The stages are the TPU's; only where a pair's two values live is chosen
// for the card.  A thread holds V = qzp_bit_v(m) indexes of a segment (a
// column of 8 or fewer whole, else 4: at 8 values and 4 warps to a segment
// of 1024, ptxas kept a stage's 8 shuffles in one register, one after
// another, and the sort took 2.6 times as long on an H100 as at 4 values
// and 8 warps), blocked: slot q = s T + t (T = m / V slots a segment)
// holds indexes t V .. t V + V - 1 of segment s as its values 0 .. V - 1.
// Stage (k, j) pairs
//   * j < V: two values of one slot, in registers (QZP_BIT_REGS);
//   * V <= j < 32 V: value e of slot q with value e of slot q ^ (j / V), a
//     lane of the same warp, by a shuffle (QZP_BIT_SHFL);
//   * 32 V <= j: the same through shared memory behind a barrier
//     (QZP_BIT_SMEM; segments of more than 32 slots only).
#define QZP_BIT_MIN_N 32     // the tiles the kernel takes: 32 .. 4096
#define QZP_BIT_MAX_N 4096   // elements, powers of 2

enum { QZP_BIT_REGS, QZP_BIT_SHFL, QZP_BIT_SMEM };

__host__ __device__ constexpr int qzp_bit_v(int m) {
  return m <= 8 ? m : 4;
}

__host__ __device__ constexpr int qzp_bit_where(int j, int v) {
  return j < v ? QZP_BIT_REGS : j < 32 * v ? QZP_BIT_SHFL : QZP_BIT_SMEM;
}

// A tile of n in segments of m: V values a slot, T slots a segment, n / V
// slots, run by a CTA of `threads` (a warp at least, at most 1024: thread
// h takes slots h, h + threads, ...; a segment of more than one slot has
// one thread a slot).
struct QzpBitPlan {
  int v;
  int t;
  int slots;
  int threads;
};

__host__ __device__ inline QzpBitPlan qzp_bit_plan(int n, int m) {
  QzpBitPlan p;
  p.v = qzp_bit_v(m);
  p.t = m / p.v;
  p.slots = n / p.v;
  p.threads = p.slots < 32 ? 32 : p.slots > 1024 ? 1024 : p.slots;
  return p;
}

// The tile place of value e of slot q
__host__ __device__ inline int qzp_bit_place(const QzpBitPlan& p, int q,
                                             int e, int seg_stride,
                                             int elem_stride) {
  return q / p.t * seg_stride + (q % p.t * p.v + e) * elem_stride;
}

__host__ __device__ inline int32_t qzp_bit_pick(int32_t a, int32_t b,
                                                bool lo) {
  const int32_t mn = a < b ? a : b, mx = a < b ? b : a;
  return lo ? mn : mx;
}

// Stage (k, j), j < V, over the values x of slot t of its segment
template <int V>
__host__ __device__ inline void qzp_bit_regs(int32_t* x, int t, int k,
                                             int j) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int e = 0; e < V; ++e)
    if (!(e & j)) {
      const bool asc = ((t * V + e) & k) == 0;
      const int32_t a = x[e], b = x[e | j];
      x[e] = qzp_bit_pick(a, b, asc);
      x[e | j] = qzp_bit_pick(a, b, !asc);
    }
}

// Stage (k, j), V <= j: whether slot t of its segment keeps the smaller of
// each value and its partner's (slot t ^ (j / V)'s)
__host__ __device__ inline bool qzp_bit_keeps_min(int t, int v, int k,
                                                  int j) {
  return ((t & (j / v)) == 0) == (((t * v) & k) == 0);
}

// -- BITONIC over a row of 65536: a cluster a row ----------------------------
//
// probe_pallas.py k_bitonic / k_bitonic3 (p_bitonic, p_bitonic_grid,
// p_bitonic_grid2): each row of 65536 int32 sorted ascending in signed
// order by the same network, 16 stages of 136 passes in all.  A row is
// spread over a cluster of C = QZP_ROW_CTAS (16) CTAs of T = N / V (1024)
// threads: CTA r holds indexes r N .. r N + N - 1 (N = 65536 / C = 4096),
// thread h of it the V = QZP_ROW_V (4) consecutive values of row slot t =
// r T + h, as qzp_bit_plan places a tile of N; a pass's direction comes
// from t.  Pass (k, j) with j < N stays in the CTA (qzp_bit_where); with
// j >= N (QZP_BIT_CLUSTER, the log2 C (log2 C + 1) / 2 passes of the
// stages past N) value e of slot t meets value e of slot t ^ (j / V): the
// same thread of CTA r ^ (j / N).  The plan's functions take the cluster's
// size (2^lc CTAs, N = 2^ln values a CTA), which the host shim also checks
// at 8 CTAs.
//
// The passes across CTAs swap their values through receive buffers in
// shared memory, each counted on the receiver's mbarrier of that buffer.
// A buffer may be written again only once every CTA that reads it has read
// it, and nothing but the passes' own exchanges orders the CTAs of a
// cluster: a CTA that has not yet met CTA s can be any number of passes
// ahead of it.  Pass p goes to buffer p % NB; a write of pass p into CTA s
// follows s's read of pass p - NB (the buffer's previous use) only if the
// partners of passes p - NB + 1 .. p - 1 lead to s (the mask of pass p is
// one of theirs).  The first pass of the last stage meets a partner met
// by no earlier pass, so NB is at least one more than the passes before
// that stage; qzp_row_buffers is that number (7 at C 16, 4 at C 8), and
// test_torch_csrc_host.py checks that it suffices and that two buffers
// would not.
#define QZP_ROW_N 65536
#define QZP_ROW_LG 16
#define QZP_ROW_CTAS 16
#define QZP_ROW_V 4

enum { QZP_BIT_CLUSTER = QZP_BIT_SMEM + 1 };

__host__ __device__ constexpr int qzp_row_where(int j, int v, int n) {
  return j >= n ? QZP_BIT_CLUSTER : qzp_bit_where(j, v);
}

// The passes across CTAs of a sort, at clusters of 2^lc CTAs
__host__ __device__ constexpr int qzp_row_passes(int lc) {
  return lc * (lc + 1) / 2;
}

// The receive buffers (and mbarriers) of a CTA, at clusters of 2^lc CTAs
__host__ __device__ constexpr int qzp_row_buffers(int lc) {
  return lc * (lc - 1) / 2 + 1;
}

// The number, among the passes across CTAs, of pass (2^lk, 2^lj), lj >= ln
// (N = 2^ln values a CTA): the passes of the stages before, then its own
__host__ __device__ constexpr int qzp_row_pass(int lk, int lj, int ln) {
  return (lk - 1 - ln) * (lk - ln) / 2 + (lk - 1 - lj);
}

// The CTA that pass (k, j) pairs CTA rank with
__host__ __device__ constexpr int qzp_row_partner(int rank, int j, int n) {
  return rank ^ (j / n);
}

// The parity of the phase of its buffer (p % NB) that pass p of sort rep
// waits for: the buffer's uses before it, rep sorts of U each and this
// sort's p / NB
__host__ __device__ constexpr unsigned qzp_row_parity(int lc, int p,
                                                      int rep) {
  return (unsigned)(rep * ((qzp_row_passes(lc) - 1 - p % qzp_row_buffers(lc))
                           / qzp_row_buffers(lc) + 1)
                    + p / qzp_row_buffers(lc)) & 1u;
}

// A CTA's shared memory: two buffers of N words for the passes across
// warps, the receive buffers of the passes across CTAs
__host__ __device__ constexpr int qzp_row_smem(int n) {
  return (2 + qzp_row_buffers(QZP_ROW_LG - qzp_lg(n))) * n * 4;
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
