// Device CRC32 / Adler-32 kernel (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/checksums.py:91 (crc32_blocks) and :139
// (adler32_blocks), XLA code in the reference, whose plain torch port
// (qatzip_tpu_torch/ops/checksums.py) right-aligns every row and folds it
// with a log-depth tree of GF(2) matrix applies and a 25-step ladder, about
// 16 launches an apply and several hundred a call.
//
// What bounds it on this card: bytes, at the sizes the engines give it (a
// [128, 65536] batch is 8 MB, 2.5 us at the HBM rate; a spec round's 8 rows
// 0.5 MB), and at 8 rows the latency of a load and of the joins.  The
// design (csrc/checksum.cuh holds the per-thread logic and the slicing):
//  * one launch, a thread-block cluster of P CTAs a row (qz_ck_plan: 8 at a
//    spec round's 8 rows, so 64 SMs share the rows; 1, a plain launch, at
//    an encoder batch's 128 rows, where a cluster's barriers and the
//    deeper join cost more than the SMs they fill), 256 threads a CTA, a
//    contiguous slice a thread;
//  * the tables come from device memory, built once a device
//    (ops/checksums._kernel_tables), 12 KB copied to shared memory a CTA
//    instead of four dependent build passes;
//  * a thread loads 8 words of its slice at once (8 bytes a load where the
//    row is 8-byte aligned) and walks its chain of slice-by-8 lookups
//    (Adler-32: two dp4a a word);
//  * the joins: CRC32 by the zero-advance matrices, in a tree of warp
//    shuffles, then the CTA's 8 warps, then the cluster's CTAs through
//    distributed shared memory into rank 0, which finishes the row; Adler
//    sums add.  No scratch in device memory, no counter, no second launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "checksum.cuh"

namespace cg = cooperative_groups;

__device__ inline void qz_ck_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ inline void qz_ck_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

#define QZ_CK_WARPS (QZ_CK_THREADS / 32)

// The values of lanes 0 .. n_in - 1 (n_in a power of 2 up to 32) joined in
// lane order into lane 0: CRC32 registers of 2^k0 bytes each by the
// zero-advance matrices (kind 0), Adler sums added (kind 1; a and b).
__device__ inline void qz_ck_warp_join(const uint32_t* zadv, int kind,
                                       int k0, int n_in, uint32_t* a,
                                       uint32_t* b) {
  for (int l = 0; (1 << l) < n_in; ++l) {
    const uint32_t ra = __shfl_down_sync(0xFFFFFFFFu, *a, 1 << l);
    const uint32_t rb = __shfl_down_sync(0xFFFFFFFFu, *b, 1 << l);
    if (kind == 0) {
      *a = qz_crc_join(zadv, k0 + l, *a, ra);
    } else {
      *a = qz_adler_add(*a, ra);
      *b = qz_adler_add(*b, rb);
    }
  }
}

__global__ void __launch_bounds__(QZ_CK_THREADS)
    qz_checksum_kernel(QzCkArgs a, QzCkPlan pl) {
  __shared__ __align__(16) uint32_t tab[QZ_CK_TABLE_WORDS];
  __shared__ uint32_t red[2][QZ_CK_WARPS];
  __shared__ uint32_t from[2][QZ_CK_CLUSTER_MAX];
  cg::cluster_group cl = cg::this_cluster();
  const bool joined = pl.p > 1;   // a cluster to join the row's values over
  if (joined) qz_ck_cluster_arrive();   // every CTA has started before
                                        // rank 0 is written
  const int r = joined ? (int)cl.block_rank() : 0;
  const int row = blockIdx.x >> pl.p_lg;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int len = qz_ck_len(a, row);
  const uint32_t* zadv = tab + QZ_CK_TAB;
  if (a.kind == 0) {   // the tables, a thread's loads at once
    constexpr int n4 = QZ_CK_TABLE_WORDS / 4;
    constexpr int per = (n4 + QZ_CK_THREADS - 1) / QZ_CK_THREADS;
    uint4 x[per];
#pragma unroll
    for (int u = 0; u < per; ++u) {
      const int i = t + u * QZ_CK_THREADS;
      x[u] = i < n4 ? reinterpret_cast<const uint4*>(a.tables)[i]
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < per; ++u) {
      const int i = t + u * QZ_CK_THREADS;
      if (i < n4) reinterpret_cast<uint4*>(tab)[i] = x[u];
    }
    __syncthreads();
  }
  uint32_t v, v2;
  qz_ck_thread(pl, tab, a.kind, a.data + (int64_t)row * a.stride, len, r, t,
               &v, &v2);
  // the slices joined over the warp, the CTA, the cluster
  qz_ck_warp_join(zadv, a.kind, pl.s_lg, 32, &v, &v2);
  if (lane == 0) {
    red[0][warp] = v;
    red[1][warp] = v2;
  }
  __syncthreads();
  if (joined) qz_ck_cluster_wait();
  if (warp == 0) {
    v = lane < QZ_CK_WARPS ? red[0][lane] : 0u;
    v2 = lane < QZ_CK_WARPS ? red[1][lane] : 0u;
    qz_ck_warp_join(zadv, a.kind, pl.s_lg + 5, QZ_CK_WARPS, &v, &v2);
    if (lane == 0) {
      *cl.map_shared_rank(&from[0][r], 0) = v;
      *cl.map_shared_rank(&from[1][r], 0) = v2;
    }
  }
  if (joined)
    cl.sync();   // the CTAs' values are in rank 0's shared memory
  else
    __syncthreads();
  if (r == 0 && warp == 0) {
    v = lane < pl.p ? from[0][lane] : 0u;
    v2 = lane < pl.p ? from[1][lane] : 0u;
    qz_ck_warp_join(zadv, a.kind, pl.s_lg + 8, pl.p, &v, &v2);
    if (lane == 0)
      a.out[row] = (int64_t)(a.kind == 0
                                 ? qz_crc_finish(tab + QZ_CK_UNPAD_AT, v, len)
                                 : qz_adler_finish(v, v2, len));
  }
}

// out int64 [rows]: the CRC32 (kind 0) or Adler-32 (kind 1) of each row's
// first len[row] bytes (len int32, or int64 where len64; clamped to
// [0, n]), rows of data at stride bytes; tables the QZ_CK_TABLE_WORDS
// words of ops/checksums._kernel_tables (read for CRC32 only), 16-byte
// aligned.  One launch: rows clusters of qz_ck_plan's P CTAs.
extern "C" int qz_checksum(const void* data, long long stride,
                           const void* len, int len64, const void* tables,
                           void* out, int rows, int n, int kind,
                           void* stream) {
  if (rows < 1 || n < 0 || n >= (1 << QZ_CK_ZADV) ||
      (kind != 0 && kind != 1) || ((uintptr_t)tables & 15u))
    return (int)cudaErrorInvalidValue;
  const QzCkPlan pl = qz_ck_plan(rows, n);
  if ((int64_t)rows * pl.p > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const QzCkArgs a = {(const uint8_t*)data, (int64_t)stride, len, len64,
                      (const uint32_t*)tables, (int64_t*)out, rows, n, kind};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl.p;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * pl.p));
  cfg.blockDim = dim3(QZ_CK_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = pl.p > 1;   // a plain launch where a CTA takes a row
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qz_checksum_kernel, a, pl);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

// The slicing of a launch over rows of n bytes: info[0] CTAs a row, [1]
// log2 of a slice's bytes, [2] log2 of the bytes the slices span, [3] the
// clusters the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int qz_checksum_plan(int rows, int n, int* info) {
  if (rows < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const QzCkPlan pl = qz_ck_plan(rows, n);
  info[0] = pl.p;
  info[1] = pl.s_lg;
  info[2] = pl.n_lg;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl.p;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.p);
  cfg.blockDim = dim3(QZ_CK_THREADS);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&info[3], qz_checksum_kernel,
                                             &cfg);
}
