// The chain walk of the parity engines: one thread's or one warp's share
// of each phase, on either path of csrc/chain.cu.
//
// The recurrence of qatzip_tpu/ops/deflate_encode.py:294-322 (the device
// encoder's greedy parse) and qatzip_tpu/ops/deflate_decode.py:282-313 (the
// speculative decoder's symbol chain), ported as plain torch in
// qatzip_tpu_torch/ops/chain.py (chain_walk_ref).  A row is a successor map
// f over positions [0, n) with i < f[i] <= n; the chain is 0, f[0],
// f[f[0]], ... up to n.  The row is cut into segments of SEG positions
// (n % SEG == 0); the output row, [n / SEG, SEG], holds in row s the SEG
// positions the walk from segment s's entry visits, in order, the first
// position past the segment repeated once the walk leaves it.
//
// Two paths (qz_chain_plan picks one from n and SEG):
//  * the cluster path, one launch: a thread-block cluster of C CTAs a row,
//    each CTA holding a contiguous share of the row's segments in shared
//    memory for the whole walk, each word as an offset from its segment's
//    first position (qz_chain_stage4, qz_chain_exits_part and
//    qz_chain_exits_double, qz_chain_share_entries and
//    qz_chain_share_verify, qz_chain_walk32_local, qz_chain_flush);
//  * the row path for rows too long for a cluster, three launches through
//    device memory (qz_chain_stage, qz_chain_unstage, qz_chain_exits,
//    qz_chain_entries, qz_chain_walk32 over the map, qz_chain_flush).
//
// __host__ __device__ so that g++ builds the same functions for the CPU
// tests (tests/test_torch_csrc_host.py), which run a launch's CTAs, warps
// and lanes one after another.
//
// PRECONDITION: i < f[i] <= n on every row, as both callers guarantee.  A
// map outside it gives unspecified positions, never a read outside the
// row, the segment or the shared memory, and never a hang.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define QZ_CHAIN_UNROLL _Pragma("unroll 8")
#define QZ_CHAIN_UNROLL_ALL _Pragma("unroll")
#else
#define QZ_CHAIN_UNROLL
#define QZ_CHAIN_UNROLL_ALL
#endif

#define QZ_CHAIN_LANES 32        // segments a warp (phases A and C)
#define QZ_CHAIN_MAX_SEG 1024    // phase A stages 32 segments of it
#define QZ_CHAIN_TILE 33         // words a row of phase C's store tile
#define QZ_CHAIN_ROWS_CTA 1      // rows a CTA of the row path's phase B: a
                                 // row's chain of loads an SM (128 rows on
                                 // one SM took 3x the loads' latency on the
                                 // H100)
#define QZ_CHAIN_SHARE 32768     // words of f a CTA of the cluster path
                                 // holds at most (128 KB; one CTA an SM)
#define QZ_CHAIN_CLUSTER_MAX 16  // CTAs a cluster: beyond the portable 8,
                                 // a size the H100 holds (the decoder's
                                 // rounds of 2^19 positions)
#define QZ_CHAIN_THREADS 256     // threads a CTA of the cluster path: up
                                 // to a segment a thread; all stage (and
                                 // 255 registers a thread)
#define QZ_CHAIN_PARTS_MAX 8     // threads a segment in phase A at most

struct QzChainArgs {
  const int32_t* f;   // [B, n] successor map
  int32_t* out;       // [B, n] visited; on the row path each segment's
                      // exits X between phases A and B
  int32_t* ent;       // [B, n / seg] segment entries (the row path)
  int rows, n, seg;
  int seg_lg;         // log2(seg)
};

// The cluster path's launch shape for rows of n positions in segments of
// seg: c CTAs a row (a cluster) of QZ_CHAIN_THREADS threads, spc segments
// a CTA (the last CTA of a row may hold fewer), parts threads a segment in
// phase A (a power of 2, each a part of seg / parts positions), and the
// CTA's dynamic shared memory: its share of f at a stride of seg + 1 words
// a segment, phase C's tiles, the entries and the handoff word
// (qz_chain_smem).  c is 0 where the row needs more than
// QZ_CHAIN_CLUSTER_MAX CTAs of at most share words: the row path takes
// it.  share is QZ_CHAIN_SHARE on the card; the host tests pass smaller
// shares to cut small rows into many CTAs.
struct QzChainPlan {
  int c, spc, parts, smem;
};

__host__ __device__ inline int qz_chain_walk_warps(int spc) {
  return (spc + QZ_CHAIN_LANES - 1) / QZ_CHAIN_LANES;
}

__host__ __device__ inline QzChainPlan qz_chain_plan(int n, int seg,
                                                     int share) {
  QzChainPlan p = {0, 0, 0, 0};
  const int nseg = n / seg;
  int most = share / seg;
  if (most > QZ_CHAIN_THREADS) most = QZ_CHAIN_THREADS;
  if (most < 1 || nseg < 1) return p;
  const int c = (nseg + most - 1) / most;
  if (c > QZ_CHAIN_CLUSTER_MAX) return p;
  p.c = c;
  p.spc = (nseg + c - 1) / c;
  p.parts = 1;
  while (2 * p.parts * p.spc <= QZ_CHAIN_THREADS &&
         2 * p.parts <= QZ_CHAIN_PARTS_MAX)
    p.parts *= 2;
  p.smem = (int)sizeof(int32_t) *
           (p.spc * (seg + 1) +
            qz_chain_walk_warps(p.spc) * QZ_CHAIN_LANES * QZ_CHAIN_TILE +
            p.spc + 1);
  return p;
}

// Word offsets of the cluster path's shared memory: the share of f (then
// X) first, then the tiles, the entries and the handoff word.
struct QzChainSmem {
  int tile, ent, handoff;
};

__host__ __device__ inline QzChainSmem qz_chain_smem(const QzChainPlan& p,
                                                     int seg) {
  QzChainSmem m;
  m.tile = p.spc * (seg + 1);
  m.ent = m.tile + qz_chain_walk_warps(p.spc) * QZ_CHAIN_LANES * QZ_CHAIN_TILE;
  m.handoff = m.ent + p.spc;
  return m;
}

// The segments [s0, s0 + *cnt) of the row that CTA `rank` of the cluster
// holds.
__host__ __device__ inline int qz_chain_share(const QzChainPlan& p, int nseg,
                                              int rank, int* cnt) {
  const int s0 = rank * p.spc;
  const int left = nseg - s0;
  *cnt = left < 0 ? 0 : left < p.spc ? left : p.spc;
  return s0;
}

__host__ __device__ inline int64_t qz_chain_segments(const QzChainArgs& a) {
  return (int64_t)a.rows * (a.n >> a.seg_lg);
}

__host__ __device__ inline int qz_chain_pad(int w, int seg_lg) {
  return (w >> seg_lg) * ((1 << seg_lg) + 1) + (w & ((1 << seg_lg) - 1));
}

// The row path's phase A staging: the words [0, words) of the warp's
// segments, contiguous in device memory from src, into shared memory with
// each segment at a stride of seg + 1 words (so the lanes, a segment each,
// meet no bank conflict when they step through their segments together).
// A lane moves every 32nd word, so a warp's loads are coalesced, 8 of them
// in flight a lane.
__host__ __device__ inline void qz_chain_stage(
    const int32_t* __restrict__ src, int32_t* __restrict__ sm, int words,
    int seg_lg, int lane) {
  QZ_CHAIN_UNROLL
  for (int w = lane; w < words; w += QZ_CHAIN_LANES)
    sm[qz_chain_pad(w, seg_lg)] = src[w];
}

__host__ __device__ inline void qz_chain_unstage(
    const int32_t* __restrict__ sm, int32_t* __restrict__ dst, int words,
    int seg_lg, int lane) {
  QZ_CHAIN_UNROLL
  for (int w = lane; w < words; w += QZ_CHAIN_LANES)
    dst[w] = sm[qz_chain_pad(w, seg_lg)];
}

// The cluster path's staging: thread t of `step` moves every step-th
// group of 4 words (16 bytes a load on the card; src 16-byte aligned,
// words a multiple of 32), the share whose first position is base, into
// the same padded layout, each word as its offset from its segment's first
// position (mod 2^32: a word below seg is a step inside the segment).
// QZ_CHAIN_BATCH loads a thread are in flight at once: all issued
// (predicated, no branch between them) before the first store waits for
// its data.
#define QZ_CHAIN_BATCH 16
struct QzChainWords {
  int32_t x, y, z, w;
};

__host__ __device__ inline void qz_chain_stage4(
    const int32_t* __restrict__ src, uint32_t* __restrict__ sm, int words,
    int seg_lg, uint32_t base, int t, int step) {
  for (int q0 = t; 4 * q0 < words; q0 += QZ_CHAIN_BATCH * step) {
    QzChainWords v[QZ_CHAIN_BATCH];
    QZ_CHAIN_UNROLL_ALL
    for (int u = 0; u < QZ_CHAIN_BATCH; ++u) {
      const int q = q0 + u * step;
#ifdef __CUDA_ARCH__
      const int4 x = 4 * q < words ? reinterpret_cast<const int4*>(src)[q]
                                   : make_int4(0, 0, 0, 0);
      v[u] = {x.x, x.y, x.z, x.w};
#else
      if (4 * q < words)
        v[u] = {src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]};
#endif
    }
    QZ_CHAIN_UNROLL_ALL
    for (int u = 0; u < QZ_CHAIN_BATCH; ++u) {
      const int q = q0 + u * step;
      if (4 * q >= words) continue;
      const uint32_t lo = base + (((uint32_t)(4 * q) >> seg_lg) << seg_lg);
      uint32_t* d = sm + qz_chain_pad(4 * q, seg_lg);   // 4 words, a segment
      d[0] = (uint32_t)v[u].x - lo;
      d[1] = (uint32_t)v[u].y - lo;
      d[2] = (uint32_t)v[u].z - lo;
      d[3] = (uint32_t)v[u].w - lo;
    }
  }
}

// Phase A, one segment [lo, lo + seg): s holds its f and becomes, in place,
// X(i) = the first chain position from i at or past the segment's end.
// One backward pass: X(i) = f(i) if f(i) leaves the segment, else X(f(i)),
// which is already computed because f(i) > i.  The reference's clamped
// doubling gives the same: after k rounds its X(i) is f applied
// min(2^k, h(i)) times, h(i) the steps from i out of the segment, and
// h(i) <= seg since every step moves at least 1, so log2(seg) rounds end
// at the same exit.
__host__ __device__ inline void qz_chain_exits(int32_t* s, int lo, int seg) {
  const int hi = lo + seg;
  for (int i = seg - 1; i >= 0; --i) {
    const int32_t fi = s[i];
    const int j = fi - lo;   // < seg whenever fi < hi
    s[i] = fi >= hi ? fi : s[j < 0 ? 0 : j];
  }
}

// The cluster path's phase A, part q of `parts` of one segment: s holds
// the segment's offsets (staged by qz_chain_stage4); one backward pass over
// the part's positions [a, e), a = q seg / parts, e = a + seg / parts,
// turns each into the first chain offset from it at or past e (e itself or
// later, maybe still inside the segment): the exit from the part.  The
// parts run at once, a thread each.
__host__ __device__ inline void qz_chain_exits_part(uint32_t* s, int seg,
                                                    int parts, int q) {
  const uint32_t a = (uint32_t)(q * (seg / parts)), e = a + seg / parts;
  for (uint32_t i = e; i-- > a;) {
    const uint32_t fi = s[i];
    s[i] = fi >= e ? fi : s[fi];   // fi < e: a later position of the part
  }
}

// Then log2(parts) rounds (a barrier after each), every part at once:
// s[i] = s[s[i]] where s[i] is still inside the segment.  After the parts
// pass an exit lies at least a part further on; each round doubles the
// parts it jumps, a word read after its own update this round only jumps
// further, and every value is a chain position, so the rounds end at the
// first one at or past the segment's end: X.  The loads of QZ_CHAIN_LANES
// positions are issued before their stores.
__host__ __device__ inline void qz_chain_exits_double(uint32_t* s, int seg,
                                                      int parts, int q) {
  const uint32_t a = (uint32_t)(q * (seg / parts)), e = a + seg / parts;
  for (uint32_t i0 = a; i0 < e; i0 += QZ_CHAIN_LANES) {
    uint32_t x[QZ_CHAIN_LANES];
    QZ_CHAIN_UNROLL_ALL
    for (int j = 0; j < QZ_CHAIN_LANES; ++j)
      x[j] = i0 + j < e ? s[i0 + j] : (uint32_t)seg;
    QZ_CHAIN_UNROLL_ALL
    for (int j = 0; j < QZ_CHAIN_LANES; ++j)
      if (x[j] < (uint32_t)seg) x[j] = s[x[j]];
    QZ_CHAIN_UNROLL_ALL
    for (int j = 0; j < QZ_CHAIN_LANES; ++j)
      if (i0 + j < e) s[i0 + j] = x[j];
  }
}

// The row path's phase B, one row: the entries of its nseg segments, each
// the exit of the one before (the reference's first lax.scan): a dependent
// load of X a segment the chain lands in, none for a segment it jumps over.
__host__ __device__ inline void qz_chain_entries(const int32_t* X,
                                                 int32_t* ent, int n,
                                                 int seg) {
  int32_t e = 0;
  for (int s = 0, hi = seg; hi <= n; ++s, hi += seg) {
    ent[s] = e;
    if (e < hi) e = X[e < 0 ? 0 : e];
  }
}

// The cluster path's phase B, one CTA's share: the entries of its cnt
// segments [s0, s0 + cnt) from the position e, through the exits X in the
// CTA's own shared memory (offsets from each segment's first position):
// a dependent load a segment the chain lands in.  Returns the first chain
// position past the share, clamped to >= 0 so that it can never look like
// the handoff word's "nothing yet" (-1).
__host__ __device__ inline int32_t qz_chain_share_entries(const uint32_t* sm,
                                                          int32_t* ent,
                                                          int32_t e, int s0,
                                                          int cnt,
                                                          int seg_lg) {
  const uint32_t seg = 1u << seg_lg;
  uint32_t lo = (uint32_t)s0 << seg_lg;
  uint32_t off = (uint32_t)e - lo;   // from the segment's first position
  for (int s = 0; s < cnt; ++s, lo += seg, off -= seg) {
    ent[s] = (int32_t)(off + lo);
    if (off < seg) off = sm[s * (seg + 1) + off];
  }
  const int32_t out = (int32_t)(off + lo);
  return out < 0 ? 0 : out;
}

// The same walk from the true entry e (0 at the row's first CTA, else the
// one the CTA before handed over), after qz_chain_share_entries walked the
// share from a guess (its first position) into ent and returned spec.
// Both walks follow the same map, so once the true entry of a segment
// equals the guessed walk's, every later one does and so does the exit:
// the walk stops there (on the engines' maps within a segment or two; in
// the worst case it walks the whole share again).
__host__ __device__ inline int32_t qz_chain_share_verify(const uint32_t* sm,
                                                         int32_t* ent,
                                                         int32_t e, int s0,
                                                         int cnt, int seg_lg,
                                                         int32_t spec) {
  const uint32_t seg = 1u << seg_lg;
  uint32_t lo = (uint32_t)s0 << seg_lg;
  uint32_t off = (uint32_t)e - lo;
  for (int s = 0; s < cnt; ++s, lo += seg, off -= seg) {
    if (ent[s] == (int32_t)(off + lo)) return spec;
    ent[s] = (int32_t)(off + lo);
    if (off < seg) off = sm[s * (seg + 1) + off];
  }
  const int32_t out = (int32_t)(off + lo);
  return out < 0 ? 0 : out;
}

// The row path's phase C, 32 steps of one segment's walk (the reference's
// second lax.scan): row[k] gets the position of step k, then the walk
// follows f (the row's map) while it is inside the segment (p < hi).
// Returns the position after the 32 steps.
__host__ __device__ inline int32_t qz_chain_walk32(const int32_t* f,
                                                   int32_t p, int hi,
                                                   int32_t* row) {
  for (int k = 0; k < QZ_CHAIN_LANES; ++k) {
    row[k] = p;
    if (p < hi) p = f[p < 0 ? 0 : p];
  }
  return p;
}

// The cluster path's phase C, 32 steps of one segment's walk: s holds the
// segment's offsets (staged by qz_chain_stage4), off is the walk's offset
// from the segment's first position lo; row[k] gets the position of step k.
// Returns the offset after the 32 steps.
__host__ __device__ inline uint32_t qz_chain_walk32_local(const uint32_t* s,
                                                          uint32_t lo,
                                                          uint32_t off,
                                                          int seg,
                                                          int32_t* row) {
  for (int k = 0; k < QZ_CHAIN_LANES; ++k) {
    row[k] = (int32_t)(off + lo);
    if (off < (uint32_t)seg) off = s[off];
  }
  return off;
}

// Phase C, the warp's store of a tile of 32 steps of its nact segments:
// lane l writes step k0 + l of every segment, so each store of the warp is
// 32 consecutive words.
__host__ __device__ inline void qz_chain_flush(const int32_t* tile,
                                               int32_t* out, int64_t g0,
                                               int nact, int seg, int k0,
                                               int lane) {
  for (int j = 0; j < nact; ++j)
    out[(g0 + j) * seg + k0 + lane] = tile[j * QZ_CHAIN_TILE + lane];
}
