// Chain-walk kernel of the parity engines (Hopper, sm_90a).
//
// Replaces the two lax.scan walks that XLA compiles into the reference's
// device program: the greedy parse of qatzip_tpu/ops/deflate_encode.py:
// 294-322 (analyze_blocks) and the symbol chain of
// qatzip_tpu/ops/deflate_decode.py:282-313 (_decode_kernel_impl).  Their
// plain torch port (qatzip_tpu_torch/ops/chain.py, chain_walk_ref) runs
// them as Python loops of batched steps: log2(SEG) doubling steps, one step
// a segment and SEG walk steps, 3-5 launches each, some 2300 launches an
// encoder batch of 64 KB blocks and 8000 a speculative round of 2^19 bits.
// Here one C entry issues three launches (csrc/chain.cuh holds their
// per-lane logic):
//  A. a lane a segment: the warp stages its 32 segments of f in shared
//     memory with coalesced loads, each lane finds its segment's exits X in
//     one backward pass, the warp stores X (into the output, as scratch);
//  B. a thread a row, a row a CTA (so the rows' chains of loads spread
//     over the SMs): the segment entries, one dependent load of X a
//     segment;
//  C. a lane a segment: the walk from its entry, SEG steps through f (read
//     through L1), staged 32 steps at a time in a tile so that the warp's
//     stores are coalesced.
//
// What bounds it on this card: latency, not bytes.  The bytes are f read
// twice and the output written twice, tens of microseconds at most at the
// HBM rate; phase B is nseg dependent loads through L2 a row, and phases A
// and C SEG dependent shared-memory or L1 loads a lane.  The design keeps
// every step's load on chip and all launches on the stream, with no host
// round trip between them; a faster phase B (a spec round has only 8 rows)
// is a later PR's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

__global__ void __launch_bounds__(QZ_CHAIN_LANES)
    qz_chain_exits_kernel(QzChainArgs a) {
  extern __shared__ int32_t qz_chain_sm[];
  const int lane = threadIdx.x;
  const int64_t g0 = (int64_t)blockIdx.x * QZ_CHAIN_LANES;
  const int64_t left = qz_chain_segments(a) - g0;
  const int nact = left < QZ_CHAIN_LANES ? (int)left : QZ_CHAIN_LANES;
  const int seg = 1 << a.seg_lg;
  const int words = nact << a.seg_lg;
  qz_chain_stage(a.f + (g0 << a.seg_lg), qz_chain_sm, words, a.seg_lg, lane);
  __syncwarp();
  if (lane < nact) {
    const int64_t g = g0 + lane;
    const int lo = (int)(g % (a.n >> a.seg_lg)) << a.seg_lg;
    qz_chain_exits(qz_chain_sm + lane * (seg + 1), lo, seg);
  }
  __syncwarp();
  qz_chain_unstage(qz_chain_sm, a.out + (g0 << a.seg_lg), words, a.seg_lg,
                   lane);
}

__global__ void __launch_bounds__(QZ_CHAIN_ROWS_CTA)
    qz_chain_entries_kernel(QzChainArgs a) {
  const int row = blockIdx.x * QZ_CHAIN_ROWS_CTA + threadIdx.x;
  if (row < a.rows)
    qz_chain_entries(a.out + (int64_t)row * a.n,
                     a.ent + (int64_t)row * (a.n >> a.seg_lg), a.n,
                     1 << a.seg_lg);
}

__global__ void __launch_bounds__(QZ_CHAIN_LANES)
    qz_chain_walks_kernel(QzChainArgs a) {
  __shared__ int32_t tile[QZ_CHAIN_LANES * QZ_CHAIN_TILE];
  const int lane = threadIdx.x;
  const int64_t g0 = (int64_t)blockIdx.x * QZ_CHAIN_LANES;
  const int64_t left = qz_chain_segments(a) - g0;
  const int nact = left < QZ_CHAIN_LANES ? (int)left : QZ_CHAIN_LANES;
  const int nseg = a.n >> a.seg_lg;
  const int seg = 1 << a.seg_lg;
  const int64_t g = g0 + lane;
  const int32_t* f = a.f + (g / nseg) * a.n;
  const int hi = (int)(g % nseg + 1) << a.seg_lg;
  int32_t p = lane < nact ? a.ent[g] : 0;
  for (int k0 = 0; k0 < seg; k0 += QZ_CHAIN_LANES) {
    if (lane < nact)
      p = qz_chain_walk32(f, p, hi, tile + lane * QZ_CHAIN_TILE);
    __syncwarp();
    qz_chain_flush(tile, a.out, g0, nact, seg, k0, lane);
    __syncwarp();
  }
}

static int qz_chain_prepare() {
  static int rc = -1;
  if (rc < 0)
    rc = (int)cudaFuncSetAttribute(
        qz_chain_exits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        QZ_CHAIN_LANES * (QZ_CHAIN_MAX_SEG + 1) * (int)sizeof(int32_t));
  return rc;
}

// visited int32 [B, n] of the successor map f int32 [B, n], with ent int32
// [B, n / seg] as scratch; seg a power of 2 in [32, QZ_CHAIN_MAX_SEG] and
// n a multiple of it.  Three launches on the stream.  phases is a mask of
// the phases to launch (A 1, B 2, C 4): 7 computes the walk; one phase
// alone, on the scratch an earlier call left, is for timing it.
extern "C" int qz_chain_walk(const void* f, void* out, void* ent, int rows,
                             int n, int seg, int phases, void* stream) {
  int seg_lg = 0;
  while ((1 << seg_lg) < seg) ++seg_lg;
  if (rows < 1 || seg < QZ_CHAIN_LANES || seg > QZ_CHAIN_MAX_SEG ||
      (1 << seg_lg) != seg || n < seg || n % seg)
    return (int)cudaErrorInvalidValue;
  int rc = qz_chain_prepare();
  if (rc != 0) return rc;
  const QzChainArgs a = {(const int32_t*)f, (int32_t*)out, (int32_t*)ent,
                         rows, n, seg, seg_lg};
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t warps =
      (qz_chain_segments(a) + QZ_CHAIN_LANES - 1) / QZ_CHAIN_LANES;
  if (warps > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (phases & 1) {
    qz_chain_exits_kernel<<<(unsigned)warps, QZ_CHAIN_LANES,
                            QZ_CHAIN_LANES * (seg + 1) * sizeof(int32_t),
                            st>>>(a);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (phases & 2) {
    qz_chain_entries_kernel<<<(rows + QZ_CHAIN_ROWS_CTA - 1) /
                                  QZ_CHAIN_ROWS_CTA,
                              QZ_CHAIN_ROWS_CTA, 0, st>>>(a);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (phases & 4)
    qz_chain_walks_kernel<<<(unsigned)warps, QZ_CHAIN_LANES, 0, st>>>(a);
  return (int)cudaGetLastError();
}
