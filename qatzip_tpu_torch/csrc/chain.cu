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
//
// What bounds it on this card: latency, not bytes.  The bytes are f read
// once and the output written once, 20 us at the HBM rate for the encoder's
// [128, 65536] batch; the walk is three chains of dependent loads a row:
// SEG steps of a segment's exits (phase A), a step a segment for the
// entries (phase B), SEG steps of a segment's walk (phase C).  The design
// keeps every one of those loads in shared memory and the whole walk in one
// launch where a cluster holds the row (csrc/chain.cuh holds the
// per-thread logic):
//
// The cluster path (qz_chain_plan: rows of up to 16 x 32768 positions,
// 2^19, at SEG >= 128), one launch: a thread-block cluster of C CTAs a row,
// CTA r holding segments [r spc, (r + 1) spc) of the row in up to 128 KB of
// shared memory (one CTA an SM; C 2 at n = 2^16, 8 at 2^18, 16 at 2^19, a
// non-portable cluster size the H100 holds):
//  A. the CTA stages its share of f from device memory once (16-byte
//     loads, 16 a thread in flight), as offsets from each segment's first
//     position, and 1-8 threads a segment turn it into the exits X in
//     place (each a part of the segment, one backward pass, then
//     log2(parts) doubling rounds);
//  B. the CTA's thread 0 walks its share's entries through its own X from
//     the share's first position while the true entry is not known, then,
//     once the CTA before has handed it the true entry (0 at rank 0; one
//     store into this CTA's shared memory, which thread 0 polls), walks
//     again from it until the two walks meet, and hands the position past
//     its share to the next CTA.  So a row's nseg dependent loads are local
//     shared-memory loads (28.5 clocks on the H100; one from a sibling's
//     memory takes 192, qz_chain_probe) done by the C CTAs at once, and the walk from
//     CTA to CTA is a segment or two on the engines' maps (the whole share
//     again only where the walks never meet);
//  C. the CTA stages f again over X (the row is still in L2) and a lane a
//     segment walks SEG steps through shared memory, stored 32 steps at a
//     time through a tile so that the warp's stores are coalesced.
// No X or entries reach device memory.
//
// The row path, for longer rows (the speculative decoder's rounds reach
// 2^24 positions; on step 7's corpus they are 2^18 or 2^19), three
// launches through device memory:
//  A. a lane a segment: the warp stages its 32 segments of f in shared
//     memory with coalesced loads, each lane finds its segment's exits X in
//     one backward pass, the warp stores X (into the output, as scratch);
//  B. a thread a row, a row a CTA (so the rows' chains of loads spread
//     over the SMs): the segment entries, one dependent load of X a
//     segment, through L2;
//  C. a lane a segment: the walk from its entry, SEG steps through f (read
//     through L1), stored through the same tile.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace cg = cooperative_groups;

// The two halves of a cluster barrier: every thread of the cluster
// arrives, and waits later for all the others' arrivals (release/acquire at
// cluster scope), so the work between them overlaps the wait.
__device__ inline void qz_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ inline void qz_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// phases: a mask of B (2) and C (4) after A, which always runs; 7 computes
// the walk, 1 and 3 time the phases by difference.
__global__ void __launch_bounds__(QZ_CHAIN_THREADS, 1)
    qz_chain_cluster_kernel(QzChainArgs a, QzChainPlan pl, int phases) {
  extern __shared__ int4 qz_chain_cl_smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(qz_chain_cl_smem);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int t = threadIdx.x;
  const int seg = a.seg, seg_lg = a.seg_lg;
  const int64_t row = blockIdx.x / pl.c;
  int cnt;
  const int s0 = qz_chain_share(pl, a.n >> seg_lg, rank, &cnt);
  const QzChainSmem m = qz_chain_smem(pl, seg);
  const uint32_t first = (uint32_t)s0 << seg_lg;   // the share's first
  const int32_t* f = a.f + row * a.n + first;
  int32_t* ent = reinterpret_cast<int32_t*>(sm + m.ent);
  volatile int32_t* handoff = reinterpret_cast<int32_t*>(sm + m.handoff);
  if (t == 0) *handoff = -1;
  qz_cluster_arrive();   // the handoff word is set before a sibling writes it
  qz_chain_stage4(f, sm, cnt << seg_lg, seg_lg, first, t,
                   QZ_CHAIN_THREADS);
  __syncthreads();
  // A: thread t takes part t / spc of segment t % spc (a warp's threads on
  // neighbouring segments: no bank conflict)
  const int sl = t % pl.spc, q = t / pl.spc;
  const bool mine = sl < cnt && q < pl.parts;
  if (mine) qz_chain_exits_part(sm + sl * (seg + 1), seg, pl.parts, q);
  __syncthreads();
  for (int round = 1; round < pl.parts; round *= 2) {
    if (mine) qz_chain_exits_double(sm + sl * (seg + 1), seg, pl.parts, q);
    __syncthreads();
  }
  // B: thread 0 walks the share from its first position while the entry
  // is not known, then from the entry until the two walks meet
  int32_t spec = 0;
  if ((phases & 2) && t == 0)
    spec = qz_chain_share_entries(sm, ent, (int32_t)first, s0, cnt, seg_lg);
  __syncwarp();
  qz_cluster_wait();
  if ((phases & 2) && t == 0) {
    int32_t e = 0;
    if (rank > 0)
      while ((e = *handoff) < 0) {
      }
    e = qz_chain_share_verify(sm, ent, e, s0, cnt, seg_lg, spec);
    if (rank + 1 < pl.c)
      *(volatile int32_t*)cl.map_shared_rank(
          reinterpret_cast<int32_t*>(sm + m.handoff), rank + 1) = e;
  }
  __syncthreads();
  qz_cluster_arrive();   // the handoffs are done (waited for at the end)
  if (phases & 4) {
    qz_chain_stage4(f, sm, cnt << seg_lg, seg_lg, first, t,
                     QZ_CHAIN_THREADS);
    __syncthreads();
    const int warp = t / QZ_CHAIN_LANES, lane = t % QZ_CHAIN_LANES;
    const int g = warp * QZ_CHAIN_LANES;   // the warp's first segment
    if (g < cnt) {
      const int nact = cnt - g < QZ_CHAIN_LANES ? cnt - g : QZ_CHAIN_LANES;
      int32_t* tile = reinterpret_cast<int32_t*>(sm + m.tile) +
                      warp * QZ_CHAIN_LANES * QZ_CHAIN_TILE;
      const int sw = g + lane;
      const uint32_t lo = first + ((uint32_t)sw << seg_lg);
      uint32_t off = lane < nact ? (uint32_t)ent[sw] - lo : 0u;
      for (int k0 = 0; k0 < seg; k0 += QZ_CHAIN_LANES) {
        if (lane < nact)
          off = qz_chain_walk32_local(sm + sw * (seg + 1), lo, off, seg,
                                      tile + lane * QZ_CHAIN_TILE);
        __syncwarp();
        qz_chain_flush(tile, a.out + row * a.n + first, g, nact, seg, k0,
                       lane);
        __syncwarp();
      }
    }
  }
  qz_cluster_wait();   // no CTA leaves while a sibling may write its memory
}

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

// Raises each kernel's dynamic shared-memory limit once: the row path's
// phase A to 32 segments of QZ_CHAIN_MAX_SEG, the cluster kernel to the
// card's opt-in limit (each launch asks for its plan's bytes), and lets
// the cluster kernel take clusters of more than 8 CTAs.
static int qz_chain_prepare() {
  static int rc = -1;
  if (rc < 0) {
    rc = (int)cudaFuncSetAttribute(
        qz_chain_exits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        QZ_CHAIN_LANES * (QZ_CHAIN_MAX_SEG + 1) * (int)sizeof(int32_t));
    int dev = 0, optin = 0;
    if (rc == 0) rc = (int)cudaGetDevice(&dev);
    if (rc == 0)
      rc = (int)cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc == 0)
      rc = (int)cudaFuncSetAttribute(
          qz_chain_cluster_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (rc == 0)
      rc = (int)cudaFuncSetAttribute(
          qz_chain_cluster_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return rc;
}

static cudaLaunchConfig_t qz_chain_config(const QzChainPlan& pl,
                                          unsigned clusters, cudaStream_t st,
                                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * pl.c);
  cfg.blockDim = dim3(QZ_CHAIN_THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static bool qz_chain_shape_ok(int rows, int n, int seg, int* seg_lg) {
  *seg_lg = 0;
  while ((1 << *seg_lg) < seg) ++*seg_lg;
  return rows >= 1 && seg >= QZ_CHAIN_LANES && seg <= QZ_CHAIN_MAX_SEG &&
         (1 << *seg_lg) == seg && n >= seg && n % seg == 0;
}

// visited int32 [B, n] of the successor map f int32 [B, n]; seg a power of
// 2 in [32, QZ_CHAIN_MAX_SEG] and n a multiple of it.  Rows that
// qz_chain_plan fits in a cluster take one launch (f 16-byte aligned; ent
// unused, may be null); longer rows three, with ent int32
// [B, n / seg] as scratch.  phases is a mask of the phases to launch
// (A 1, B 2, C 4; the cluster path always runs A): 7 computes the walk;
// 1 and 3, on the scratch an earlier call left, are for timing them.
extern "C" int qz_chain_walk(const void* f, void* out, void* ent, int rows,
                             int n, int seg, int phases, void* stream) {
  int seg_lg;
  if (!qz_chain_shape_ok(rows, n, seg, &seg_lg))
    return (int)cudaErrorInvalidValue;
  int rc = qz_chain_prepare();
  if (rc != 0) return rc;
  const QzChainArgs a = {(const int32_t*)f, (int32_t*)out, (int32_t*)ent,
                         rows, n, seg, seg_lg};
  const cudaStream_t st = (cudaStream_t)stream;
  const QzChainPlan pl = qz_chain_plan(n, seg, QZ_CHAIN_SHARE);
  if (pl.c > 0) {
    if ((uintptr_t)f & 15u) return (int)cudaErrorMisalignedAddress;
    if ((int64_t)rows * pl.c > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = qz_chain_config(pl, (unsigned)rows, st,
                                                   &attr);
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, qz_chain_cluster_kernel, a, pl, phases);
    const cudaError_t last = cudaGetLastError();   // clears a refused launch
    return (int)(err != cudaSuccess ? err : last);
  }
  if (ent == nullptr) return (int)cudaErrorInvalidValue;
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

// The path for rows of n positions in segments of seg: info[0] CTAs a
// cluster (0: the row path), [1] segments a CTA, [2] threads a segment in
// phase A, [3] shared bytes a CTA, [4] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 on the row path).
extern "C" int qz_chain_info(int n, int seg, int* info) {
  int seg_lg;
  if (!qz_chain_shape_ok(1, n, seg, &seg_lg))
    return (int)cudaErrorInvalidValue;
  const QzChainPlan pl = qz_chain_plan(n, seg, QZ_CHAIN_SHARE);
  info[0] = pl.c;
  info[1] = pl.spc;
  info[2] = pl.parts;
  info[3] = pl.smem;
  info[4] = 0;
  if (pl.c == 0) return 0;
  int rc = qz_chain_prepare();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qz_chain_config(pl, 1u, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(&info[4], qz_chain_cluster_kernel,
                                             &cfg);
}

#define QZ_CHAIN_PROBE_WORDS 4096

// The dependent load of phase B, alone: thread 0 of rank 0 of a cluster of
// two follows a chain of `steps` indexes through 4096 words of shared
// memory, its own (remote 0: ld.shared, the cluster path's walk) or rank
// 1's (remote 1: a load through distributed shared memory, the walk of the
// design not taken).  out[0] the clocks of the chase (clock64), out[1] its
// last index (so the chase is not optimised away).
__global__ void __cluster_dims__(2, 1, 1)
    qz_chain_probe_kernel(long long* out, int remote, int steps) {
  __shared__ int32_t buf[QZ_CHAIN_PROBE_WORDS];
  cg::cluster_group cl = cg::this_cluster();
  // a full-period step of an LCG mod 4096: every word lies on the chain
  for (int i = threadIdx.x; i < QZ_CHAIN_PROBE_WORDS; i += blockDim.x)
    buf[i] = (i * 1021 + 7) & (QZ_CHAIN_PROBE_WORDS - 1);
  cl.sync();
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    const int32_t* far = cl.map_shared_rank(buf, 1);
    int32_t p = 0;
    const long long t0 = clock64();
    if (remote) {
      for (int s = 0; s < steps; ++s) p = far[p];
    } else {
      for (int s = 0; s < steps; ++s) p = buf[p];
    }
    const long long t1 = clock64();
    out[0] = t1 - t0;
    out[1] = p;
  }
  cl.sync();
}

extern "C" int qz_chain_probe(void* out, int remote, int steps,
                              void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  qz_chain_probe_kernel<<<2, 128, 0, (cudaStream_t)stream>>>(
      (long long*)out, remote, steps);
  return (int)cudaGetLastError();
}
