// The chain walk of the parity engines: one warp's share of each phase.
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
// __host__ __device__ so that g++ builds the same functions for the CPU
// tests (tests/test_torch_csrc_host.py), which run a launch's warps and
// lanes one after another.
//
// PRECONDITION: i < f[i] <= n on every row, as both callers guarantee.  A
// map outside it gives unspecified positions, never a read outside the
// row, the segment or the shared memory.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define QZ_CHAIN_UNROLL _Pragma("unroll 8")
#else
#define QZ_CHAIN_UNROLL
#endif

#define QZ_CHAIN_LANES 32        // segments a warp (phases A and C)
#define QZ_CHAIN_MAX_SEG 1024    // phase A stages 32 segments of it
#define QZ_CHAIN_TILE 33         // words a row of phase C's store tile
#define QZ_CHAIN_ROWS_CTA 1      // rows a CTA of phase B: a row's chain
                                 // of loads an SM (128 rows on one SM took
                                 // 3x the loads' latency on the H100)

struct QzChainArgs {
  const int32_t* f;   // [B, n] successor map
  int32_t* out;       // [B, n] visited; each segment's exits X between
                      // phases A and B
  int32_t* ent;       // [B, n / seg] segment entries
  int rows, n, seg;
  int seg_lg;         // log2(seg)
};

__host__ __device__ inline int64_t qz_chain_segments(const QzChainArgs& a) {
  return (int64_t)a.rows * (a.n >> a.seg_lg);
}

// Phase A, the staging: the words [0, words) of the warp's segments,
// contiguous in device memory from src, into shared memory with each
// segment at a stride of seg + 1 words (so the lanes, a segment each, meet
// no bank conflict when they step through their segments together).  A
// lane moves every 32nd word, so a warp's loads are coalesced, 8 of them
// in flight a lane.
__host__ __device__ inline void qz_chain_stage(
    const int32_t* __restrict__ src, int32_t* __restrict__ sm, int words,
    int seg_lg, int lane) {
  QZ_CHAIN_UNROLL
  for (int w = lane; w < words; w += QZ_CHAIN_LANES)
    sm[(w >> seg_lg) * ((1 << seg_lg) + 1) + (w & ((1 << seg_lg) - 1))] =
        src[w];
}

__host__ __device__ inline void qz_chain_unstage(
    const int32_t* __restrict__ sm, int32_t* __restrict__ dst, int words,
    int seg_lg, int lane) {
  QZ_CHAIN_UNROLL
  for (int w = lane; w < words; w += QZ_CHAIN_LANES)
    dst[w] =
        sm[(w >> seg_lg) * ((1 << seg_lg) + 1) + (w & ((1 << seg_lg) - 1))];
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

// Phase B, one row: the entries of its nseg segments, each the exit of the
// one before (the reference's first lax.scan): a dependent load of X a
// segment the chain lands in, none for a segment it jumps over.
__host__ __device__ inline void qz_chain_entries(const int32_t* X,
                                                 int32_t* ent, int n,
                                                 int seg) {
  int32_t e = 0;
  for (int s = 0, hi = seg; hi <= n; ++s, hi += seg) {
    ent[s] = e;
    if (e < hi) e = X[e < 0 ? 0 : e];
  }
}

// Phase C, 32 steps of one segment's walk (the reference's second
// lax.scan): row[k] gets the position of step k, then the walk follows f
// while it is inside the segment (p < hi <= n).  Returns the position
// after the 32 steps.
__host__ __device__ inline int32_t qz_chain_walk32(const int32_t* f,
                                                   int32_t p, int hi,
                                                   int32_t* row) {
  for (int k = 0; k < QZ_CHAIN_LANES; ++k) {
    row[k] = p;
    if (p < hi) p = f[p < 0 ? 0 : p];
  }
  return p;
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
