// Logic of the bitonic u32 sort of csrc/sort.cu: the network, the level
// each pass runs at, where each element lives, and the compare-exchange.
//
// The network is qatzip_tpu/ops/pallas_sort.py:_bitonic_body: stages
// k = 2, 4, .., n, and in each stage passes j = k/2, .., 1; the pass pairs
// element i with i ^ j and sorts the pair ascending when bit k of i is clear
// (descending otherwise).  Keys compare as uint32; payloads move with their
// key.
//
// A row of n elements is cut into segments of `span` elements, one thread
// block cluster each (the whole row when it fits); CTA `rank` of a cluster
// holds the m elements from rank * m of its segment in shared memory, one
// record (key, payloads) an element at the place qz_sort_swz gives it.  A
// run of passes is a step at one of three levels:
//   * QZ_SORT_REGS: the passes whose strides are bits g .. g+w-1 of the
//     index (w <= QZ_SORT_LOG_E).  Each thread loads groups of 2^w elements
//     that differ only in those bits from shared memory into registers, runs
//     the passes there, and stores them back: one shared-memory round trip
//     for w passes.  The first step runs all of stages 2 .. 2^QZ_SORT_LOG_E.
//     (A warp-shuffle level would move each word once a pass; a round trip
//     moves it twice for up to QZ_SORT_LOG_E passes, so there is none.)
//   * QZ_SORT_CLUSTER: one pass with m <= j < span.  Every slot reads its
//     partner, at the same place in CTA rank ^ (j / m), through distributed
//     shared memory and takes the partner's record or keeps its own
//     (qz_sort_take), so each CTA writes only its own shared memory.
//   * QZ_SORT_GLOBAL: one pass with j >= span, over device memory.
// __host__ __device__ so that g++ builds the same functions for the CPU
// tests (tests/test_torch_csrc_host.py), which replay the schedule.
#pragma once
#include <stdint.h>

#define QZ_SORT_MAX_PAYLOADS 4
#define QZ_SORT_MIN_N 1024
#define QZ_SORT_MAX_CLUSTER 8   // the portable limit of CTAs in a cluster

#ifdef __CUDACC__
#define QZ_UNROLL _Pragma("unroll")
#else
#define QZ_UNROLL
#endif

enum { QZ_SORT_REGS = 0, QZ_SORT_CLUSTER = 1, QZ_SORT_GLOBAL = 2 };

// One row's arrays in device memory (the global passes).
struct QzSortRow {
  uint32_t* key;
  uint32_t* pay[QZ_SORT_MAX_PAYLOADS];
  int npay;
};

// A key and its payloads.
template <int NPAY>
struct QzSortRec {
  uint32_t key;
  uint32_t pay[NPAY > 0 ? NPAY : 1];
};

// Words of an element's record in shared memory: the key, then the
// payloads, padded to an odd count, so that records whose swizzled indices
// (qz_sort_swz) differ mod 32 start in 32 different banks.
__host__ __device__ constexpr uint32_t qz_sort_rec_words(int npay) {
  return (1u + (uint32_t)npay) | 1u;
}

// Tuning, measured on the card (PERF.md): threads of a CTA, the log2 of the
// elements a thread's register group holds, and a CTA's shared memory.
constexpr int QZ_SORT_THREADS = 512;
constexpr int QZ_SORT_LOG_E = 4;
constexpr uint32_t QZ_SORT_CTA_BYTES = 192 * 1024;

// Elements a CTA holds at most: the largest power of 2 whose records fit
// QZ_SORT_CTA_BYTES.
__host__ __device__ constexpr uint32_t qz_sort_cta_cap(int npay) {
  uint32_t m = 1u;
  while ((m << 1) * 4u * qz_sort_rec_words(npay) <= QZ_SORT_CTA_BYTES)
    m <<= 1;
  return m;
}

// A cluster of more than one CTA holds qz_sort_cta_cap elements a CTA (the
// least with 4 payloads), and a pass between its CTAs takes
// 2^QZ_SORT_LOG_E slots a thread at a time.
static_assert(qz_sort_cta_cap(QZ_SORT_MAX_PAYLOADS) % (QZ_SORT_THREADS
                                                       << QZ_SORT_LOG_E) == 0,
              "a cluster pass needs 2^QZ_SORT_LOG_E slots a thread");

// The shape of a launch: CTAs of m = min(n, qz_sort_cta_cap) elements, and
// as many to a cluster as the row needs, up to QZ_SORT_MAX_CLUSTER.
struct QzSortPlan {
  uint32_t m;      // elements a CTA holds
  uint32_t c;      // CTAs a cluster
  uint32_t span;   // elements a cluster holds, m * c
  uint32_t bytes;  // dynamic shared memory a CTA
};

__host__ __device__ inline QzSortPlan qz_sort_plan(uint32_t n, int npay) {
  const uint32_t cap = qz_sort_cta_cap(npay);
  const uint32_t m = n < cap ? n : cap;
  uint32_t c = n / m;
  if (c > QZ_SORT_MAX_CLUSTER) c = QZ_SORT_MAX_CLUSTER;
  QzSortPlan p = {m, c, m * c, m * 4u * qz_sort_rec_words(npay)};
  return p;
}

__host__ __device__ inline int qz_log2(uint32_t x) {
  int b = 0;
  while (x >>= 1) ++b;
  return b;
}

// The lower element of the p-th pair of a pass at stride j (j a power of 2):
// the p-th index whose bit j is clear.
__host__ __device__ inline uint32_t qz_bitonic_lower(uint32_t p, uint32_t j) {
  return ((p & ~(j - 1u)) << 1) | (p & (j - 1u));
}

// In stage k the pair whose lower element has row index i sorts ascending
// when bit k of i is clear.
__host__ __device__ inline bool qz_bitonic_ascending(uint32_t i, uint32_t k) {
  return (i & k) == 0u;
}

// The compare-exchange of the p-th pair of pass (k, j) on a row in device
// memory.
__host__ __device__ inline void qz_bitonic_pair(const QzSortRow& r, uint32_t p,
                                                uint32_t j, uint32_t k) {
  const uint32_t lo = qz_bitonic_lower(p, j);
  const uint32_t hi = lo + j;
  const uint32_t a = r.key[lo];
  const uint32_t b = r.key[hi];
  if (qz_bitonic_ascending(lo, k) ? a > b : a < b) {
    r.key[lo] = b;
    r.key[hi] = a;
    // a constant trip count unrolls, so pay[] stays in registers
    for (int q = 0; q < QZ_SORT_MAX_PAYLOADS; ++q) {
      if (q >= r.npay) break;
      const uint32_t t = r.pay[q][lo];
      r.pay[q][lo] = r.pay[q][hi];
      r.pay[q][hi] = t;
    }
  }
}

// The compare-exchange in registers: a is the pair's lower element; the pair
// leaves descending when desc, ascending otherwise (equal keys may swap).
template <int NPAY>
__host__ __device__ inline void qz_sort_ce(QzSortRec<NPAY>& a,
                                           QzSortRec<NPAY>& b, bool desc) {
  const bool swap = (a.key > b.key) != desc;
  const uint32_t ka = a.key;
  a.key = swap ? b.key : ka;
  b.key = swap ? ka : b.key;
  QZ_UNROLL
  for (int q = 0; q < NPAY; ++q) {
    const uint32_t pa = a.pay[q];
    a.pay[q] = swap ? b.pay[q] : pa;
    b.pay[q] = swap ? pa : b.pay[q];
  }
}

// The compare-exchange as one slot of the pair sees it
// (pallas_sort.py:71-81): whether the slot takes its partner's record.
// upper: the slot is the pair's upper element; asc: the pair sorts
// ascending.  Both slots of a pair decide alike, so a record is neither
// lost nor doubled.
__host__ __device__ inline bool qz_sort_take(uint32_t own, uint32_t other,
                                             bool upper, bool asc) {
  return upper != asc ? other < own : other > own;
}

// Shared-memory word of element i of a CTA's array: bits 5..9 of i are
// folded into the bank bits 0..4, so that the 32 threads of a warp reach 32
// banks at every group alignment the schedule uses (the CPU tests count
// the conflicts).  Linear over xor, and a permutation of each 32 words.
__host__ __device__ inline uint32_t qz_sort_swz(uint32_t i) {
  const uint32_t h = i >> 5;
  return i ^ ((h & 1u ? 25u : 0u) ^ (h & 2u ? 18u : 0u) ^
              (h & 4u ? 29u : 0u) ^ (h & 8u ? 17u : 0u) ^
              (h & 16u ? 14u : 0u));
}

// Element of slot 0 of the q-th group of a register step on bits
// g .. g+w-1: q with w zero bits put in at bit g.  Slot s adds s << g.
__host__ __device__ inline uint32_t qz_sort_group_base(uint32_t q, int g,
                                                       int w) {
  return ((q >> g) << (g + w)) | (q & ((1u << g) - 1u));
}

// The shared-memory words of the slots of the group whose slot 0 is base.
template <int W>
__host__ __device__ inline void qz_sort_group_slots(uint32_t base, int g,
                                                    uint32_t (&p)[1 << W]) {
  uint32_t bit[W];
  QZ_UNROLL
  for (int c = 0; c < W; ++c) bit[c] = qz_sort_swz(1u << (g + c));
  const uint32_t p0 = qz_sort_swz(base);
  QZ_UNROLL
  for (int s = 0; s < (1 << W); ++s) {
    uint32_t a = p0;
    QZ_UNROLL
    for (int c = 0; c < W; ++c)
      if (s & (1 << c)) a ^= bit[c];
    p[s] = a;
  }
}

// A run of passes at one level.  It starts at pass (k, j); a register step
// ends at the pass of stride 1 << g of stage k_last (k_last > k only for
// the first step, which runs stages 2 .. 2^QZ_SORT_LOG_E whole).
struct QzSortStep {
  int level;
  uint32_t k, j, k_last;
  int g, w;
};

// The step that starts at pass (k, j) of a launch whose clusters hold span
// elements in CTAs of m.
__host__ __device__ inline QzSortStep qz_sort_step(uint32_t k, uint32_t j,
                                                   uint32_t m, uint32_t span) {
  QzSortStep st = {QZ_SORT_GLOBAL, k, j, k, 0, 1};
  if (j >= span) return st;
  if (j >= m) {
    st.level = QZ_SORT_CLUSTER;
    return st;
  }
  st.level = QZ_SORT_REGS;
  if (k == 2u) {
    st.k_last = 1u << QZ_SORT_LOG_E;
    st.w = QZ_SORT_LOG_E;
    return st;
  }
  // strides in groups of QZ_SORT_LOG_E bits from bit 0 up, a part group on
  // top
  const int b = qz_log2(j);
  st.g = b / QZ_SORT_LOG_E * QZ_SORT_LOG_E;
  st.w = b - st.g + 1;
  return st;
}

// Moves (k, j) to the pass after step st.
__host__ __device__ inline void qz_sort_advance(const QzSortStep& st,
                                                uint32_t* k, uint32_t* j) {
  if (st.level != QZ_SORT_REGS) {
    *j >>= 1;
  } else if (st.g > 0) {
    *j = 1u << (st.g - 1);
  } else {
    *k = st.k_last << 1;
    *j = st.k_last;
  }
}

// The steps of one cluster launch, in order: k_merge == 0 runs stages
// 2 .. span whole, otherwise the passes j < span of stage k_merge.
//   QzSortStep st;
//   for (QzSortWalk w = qz_sort_walk(pl, k_merge); qz_sort_next(&w, &st);)
struct QzSortWalk {
  uint32_t k, j, k_end, m, span;
};

__host__ __device__ inline QzSortWalk qz_sort_walk(const QzSortPlan& pl,
                                                   uint32_t k_merge) {
  QzSortWalk w = {k_merge ? k_merge : 2u, k_merge ? pl.span / 2 : 1u,
                  k_merge ? k_merge : pl.span, pl.m, pl.span};
  return w;
}

// The step at w's pass into *st, and w moved past it; false after the last.
__host__ __device__ inline bool qz_sort_next(QzSortWalk* w, QzSortStep* st) {
  if (w->k > w->k_end) return false;
  *st = qz_sort_step(w->k, w->j, w->m, w->span);
  qz_sort_advance(*st, &w->k, &w->j);
  return true;
}

// The launches that sort a row of n elements, in order: a cluster launch of
// stages 2 .. span (k_merge 0), then for each stage k beyond span a global
// pass for each stride j >= span and a cluster launch of the rest of the
// stage (k_merge k).  cluster(k_merge) and global(k, j) return false to
// stop.  Host only.
template <class Cluster, class Global>
inline bool qz_sort_launches(uint32_t n, const QzSortPlan& pl,
                             Cluster cluster, Global global) {
  if (!cluster(0u)) return false;
  for (uint32_t k = 2u * pl.span; k <= n; k <<= 1) {
    for (uint32_t j = k / 2; j >= pl.span; j >>= 1)
      if (!global(k, j)) return false;
    if (!cluster(k)) return false;
  }
  return true;
}

// The passes of register step st on one group: r[s] holds slot s, base is
// the row index of slot 0.  Every loop has a constant trip count, so that
// nvcc unrolls it and keeps r[] in registers.
template <int NPAY, int W>
__host__ __device__ inline void qz_sort_group(QzSortRec<NPAY> (&r)[1 << W],
                                              uint32_t base,
                                              const QzSortStep& st) {
  if (st.k_last == st.k) {
    // one stage on bits g .. g+W-1: k is above them, so the direction is
    // the group's
    const bool desc = (base & st.k) != 0u;
    QZ_UNROLL
    for (int c = W - 1; c >= 0; --c)
      QZ_UNROLL
      for (int s = 0; s < (1 << W); ++s)
        if (!(s & (1 << c))) qz_sort_ce<NPAY>(r[s], r[s | (1 << c)], desc);
    return;
  }
  // the first step: stages 2 .. 2^W whole on bits 0 .. W-1 (g = 0); the
  // direction of stage 2^t is bit t of the slot's row index
  QZ_UNROLL
  for (int t = 1; t <= W; ++t)
    QZ_UNROLL
    for (int c = t - 1; c >= 0; --c)
      QZ_UNROLL
      for (int s = 0; s < (1 << W); ++s)
        if (!(s & (1 << c)))
          qz_sort_ce<NPAY>(r[s], r[s | (1 << c)],
                           (((base | (uint32_t)s) >> t) & 1u) != 0u);
}
