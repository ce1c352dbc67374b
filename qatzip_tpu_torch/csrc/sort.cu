// Bitonic sort of u32 keys with up to 4 payloads (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/pallas_sort.py:sort_u32 (kernel body _mk_kernel,
// network _bitonic_body, partner roll _partner).  The TPU kernel keeps a
// whole [S, 128] row in VMEM for the whole network, so device memory sees
// one read and one write of each row.
//
// The first design of this kernel kept 1024-element tiles in shared memory
// and ran every pass of stride >= 1024 as its own launch over device
// memory: 21 launches at [128, 32768] with 2 payloads and 28 at
// [128, 65536], each reading and writing every key and payload (2.1 and
// 5.6 GB), which bounded it.
//
// Here a thread-block cluster holds the whole row, as VMEM did: each CTA
// keeps m elements (up to QZ_SORT_CTA_BYTES of dynamic shared memory; 16384
// with 2 payloads) and a cluster of up to 8 CTAs holds up to 8 m.  One
// launch loads the row, runs the network and stores it; csrc/sort.cuh says
// which level runs each pass (16-element groups in registers, one
// shared-memory round trip for up to 4 passes; the strides between CTAs
// through distributed shared memory).  Rows longer than a
// cluster holds add a global pass for each stride beyond the cluster and a
// cluster launch for the rest of each such stage.
//
// What bounds it now: the ~33-37 shared-memory round trips of a row, each
// issued by all warps between two barriers (16 warps an SM, so loads,
// compare-exchanges and stores of one CTA hardly overlap); the passes
// between CTAs, which read the partner's keys, and the payloads they take,
// at distributed shared memory's lower bandwidth; and wave quantisation:
// with 192 KB a CTA one CTA fits an SM, so 256 CTAs run as 1.94 waves on
// 132 SMs, and clusters of 4 fit 30 at once, so 512 CTAs run as 4.27.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort.cuh"

namespace cg = cooperative_groups;

// The record of an element whose swizzled index is w: shared-memory words
// REC * w .. REC * w + NPAY.
template <int NPAY>
__device__ inline QzSortRec<NPAY> qz_sort_load(const uint32_t* sm,
                                               uint32_t w) {
  const uint32_t* p = sm + qz_sort_rec_words(NPAY) * w;
  QzSortRec<NPAY> r;
  r.key = p[0];
  QZ_UNROLL
  for (int q = 0; q < NPAY; ++q) r.pay[q] = p[1 + q];
  return r;
}

template <int NPAY>
__device__ inline void qz_sort_store(uint32_t* sm, uint32_t w,
                                     const QzSortRec<NPAY>& r) {
  uint32_t* p = sm + qz_sort_rec_words(NPAY) * w;
  p[0] = r.key;
  QZ_UNROLL
  for (int q = 0; q < NPAY; ++q) p[1 + q] = r.pay[q];
}

// One register step on the CTA's m elements; cta0 is the row index of the
// CTA's element 0.
template <int NPAY, int W>
__device__ void qz_sort_regs(uint32_t* sm, uint32_t m, uint32_t cta0,
                             const QzSortStep& st) {
  if constexpr (W > 1) {
    if (st.w < W) {
      qz_sort_regs<NPAY, W - 1>(sm, m, cta0, st);
      return;
    }
  }
  for (uint32_t q = threadIdx.x; q < (m >> W); q += blockDim.x) {
    const uint32_t base = qz_sort_group_base(q, st.g, W);
    uint32_t p[1 << W];
    qz_sort_group_slots<W>(base, st.g, p);
    QzSortRec<NPAY> r[1 << W];
    QZ_UNROLL
    for (int s = 0; s < (1 << W); ++s) r[s] = qz_sort_load<NPAY>(sm, p[s]);
    qz_sort_group<NPAY, W>(r, cta0 | base, st);
    QZ_UNROLL
    for (int s = 0; s < (1 << W); ++s) qz_sort_store<NPAY>(sm, p[s], r[s]);
  }
  __syncthreads();
}

// One pass (k, j) between the CTAs of the cluster (m <= j < span).  Every
// thread holds per = m / blockDim.x slots, CH at a time (sort.cuh asserts
// that per is a multiple of CH).
template <int NPAY>
__device__ void qz_sort_cluster_pass(cg::cluster_group& cl, uint32_t* sm,
                                     uint32_t m, uint32_t rank, uint32_t cta0,
                                     uint32_t k, uint32_t j) {
  constexpr uint32_t REC = qz_sort_rec_words(NPAY);
  constexpr int CH = 1 << QZ_SORT_LOG_E;
  const uint32_t* other = cl.map_shared_rank(sm, rank ^ (j / m));
  const bool upper = (cta0 & j) != 0u;
  const bool asc = qz_bitonic_ascending(cta0, k);
  const uint32_t per = m / blockDim.x;
  cl.sync();   // the partner's last step is in its shared memory
  for (uint32_t s0 = 0; s0 < per; s0 += CH) {
    uint32_t w[CH];   // the slots' swizzled indices
    QZ_UNROLL
    for (int s = 0; s < CH; ++s)
      w[s] = qz_sort_swz((s0 + s) * blockDim.x + threadIdx.x);
    // the partner's keys first, all CH in flight before the first is used;
    // then the payloads of the records this CTA takes
    uint32_t key[CH];
    QZ_UNROLL
    for (int s = 0; s < CH; ++s) key[s] = other[REC * w[s]];
    QzSortRec<NPAY> r[CH];
    QZ_UNROLL
    for (int s = 0; s < CH; ++s) {
      r[s] = qz_sort_load<NPAY>(sm, w[s]);
      if (qz_sort_take(r[s].key, key[s], upper, asc)) {
        r[s].key = key[s];
        QZ_UNROLL
        for (int q = 0; q < NPAY; ++q) r[s].pay[q] = other[REC * w[s] + 1 + q];
      }
    }
    cl.sync();   // the partner has read these slots before they change
    QZ_UNROLL
    for (int s = 0; s < CH; ++s) qz_sort_store<NPAY>(sm, w[s], r[s]);
  }
  __syncthreads();
}

// Copies the CTA's m elements between device memory (row index g0 on) and
// shared memory, 16 bytes a thread.
template <int NPAY, bool LOAD>
__device__ void qz_sort_copy(const QzSortRow& rows, uint64_t g0, uint32_t* sm,
                             uint32_t m) {
  constexpr uint32_t REC = qz_sort_rec_words(NPAY);
  for (uint32_t v = threadIdx.x; v < m / 4; v += blockDim.x) {
    QZ_UNROLL
    for (int q = 0; q <= NPAY; ++q) {
      uint32_t* arr = q == 0 ? rows.key : rows.pay[q - 1];
      uint4* glob = reinterpret_cast<uint4*>(arr + g0) + v;
      uint32_t* s = sm + q;
      if (LOAD) {
        const uint4 x = *glob;
        s[REC * qz_sort_swz(4 * v)] = x.x;
        s[REC * qz_sort_swz(4 * v + 1)] = x.y;
        s[REC * qz_sort_swz(4 * v + 2)] = x.z;
        s[REC * qz_sort_swz(4 * v + 3)] = x.w;
      } else {
        *glob = make_uint4(s[REC * qz_sort_swz(4 * v)],
                           s[REC * qz_sort_swz(4 * v + 1)],
                           s[REC * qz_sort_swz(4 * v + 2)],
                           s[REC * qz_sort_swz(4 * v + 3)]);
      }
    }
  }
}

// One cluster a segment of `span` elements of a row.  k_merge == 0: stages
// 2 .. span whole; otherwise the passes j < span of stage k_merge.
template <int NPAY>
__global__ void __launch_bounds__(QZ_SORT_THREADS, 1)
    qz_sort_cluster_kernel(QzSortRow rows, uint32_t n, QzSortPlan pl,
                           uint32_t k_merge) {
  extern __shared__ uint4 qz_sort_smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(qz_sort_smem);
  cg::cluster_group cl = cg::this_cluster();
  const uint32_t rank = cl.block_rank();
  const uint32_t segs = n / pl.span;
  const uint32_t cluster = blockIdx.x / pl.c;
  const uint32_t cta0 = (cluster % segs) * pl.span + rank * pl.m;
  const uint64_t g0 = (uint64_t)(cluster / segs) * n + cta0;
  qz_sort_copy<NPAY, true>(rows, g0, sm, pl.m);
  __syncthreads();
  QzSortStep st;
  for (QzSortWalk w = qz_sort_walk(pl, k_merge); qz_sort_next(&w, &st);) {
    if (st.level == QZ_SORT_CLUSTER)
      qz_sort_cluster_pass<NPAY>(cl, sm, pl.m, rank, cta0, st.k, st.j);
    else
      qz_sort_regs<NPAY, QZ_SORT_LOG_E>(sm, pl.m, cta0, st);
  }
  qz_sort_copy<NPAY, false>(rows, g0, sm, pl.m);
  cl.sync();   // no CTA leaves while a sibling may still read its memory
}

// One pass (k, j) with j >= span over device memory, one thread a pair.
__global__ void qz_sort_pass_kernel(QzSortRow rows, int n, int64_t pairs,
                                    uint32_t k, uint32_t j) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int64_t half = n / 2;
  const int64_t row = i / half;
  QzSortRow r = rows;
  r.key += row * n;
  for (int q = 0; q < QZ_SORT_MAX_PAYLOADS; ++q)
    if (q < rows.npay) r.pay[q] += row * n;
  qz_bitonic_pair(r, (uint32_t)(i - row * half), j, k);
}

static cudaLaunchConfig_t qz_sort_config(const QzSortPlan& pl,
                                         unsigned clusters, cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * pl.c);
  cfg.blockDim = dim3(QZ_SORT_THREADS);
  cfg.dynamicSmemBytes = pl.bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NPAY>
static cudaError_t qz_sort_cluster_launch(const QzSortRow& rows, int B,
                                          uint32_t n, const QzSortPlan& pl,
                                          uint32_t k_merge, cudaStream_t s) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      qz_sort_config(pl, (unsigned)B * (n / pl.span), s, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, qz_sort_cluster_kernel<NPAY>, rows, n, pl,
                         k_merge);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return err != cudaSuccess ? err : last;
}

template <int NPAY>
static int qz_sort_run(const QzSortRow& rows, int B, uint32_t n,
                       cudaStream_t s) {
  const QzSortPlan pl = qz_sort_plan(n, NPAY);
  cudaError_t err = cudaFuncSetAttribute(
      qz_sort_cluster_kernel<NPAY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t pairs = (int64_t)B * (n / 2);
  const int threads = 256;
  const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
  qz_sort_launches(
      n, pl,
      [&](uint32_t k_merge) {
        err = qz_sort_cluster_launch<NPAY>(rows, B, n, pl, k_merge, s);
        return err == cudaSuccess;
      },
      [&](uint32_t k, uint32_t j) {
        qz_sort_pass_kernel<<<blocks, threads, 0, s>>>(rows, (int)n, pairs, k,
                                                       j);
        err = cudaGetLastError();
        return err == cudaSuccess;
      });
  return (int)err;
}

template <int NPAY>
static int qz_sort_info(uint32_t n, int* info) {
  const QzSortPlan pl = qz_sort_plan(n, NPAY);
  cudaError_t err = cudaFuncSetAttribute(
      qz_sort_cluster_kernel<NPAY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = qz_sort_config(pl, 1u, 0, &attr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &clusters, qz_sort_cluster_kernel<NPAY>, &cfg);
  info[0] = (int)pl.m;
  info[1] = (int)pl.c;
  info[2] = (int)pl.span;
  info[3] = (int)pl.bytes;
  info[4] = clusters;
  return (int)err;
}

static bool qz_sort_shape_ok(int n, int npay) {
  return n >= QZ_SORT_MIN_N && !(n & (n - 1)) && npay >= 0 &&
         npay <= QZ_SORT_MAX_PAYLOADS;
}

// Sorts B rows of n keys (n a power of 2, at least QZ_SORT_MIN_N) in place,
// ascending in uint32 order, moving npay payload rows with them.  Every
// array used must be 16-byte aligned.
extern "C" int qz_sort_u32(void* key, void* p0, void* p1, void* p2, void* p3,
                           int B, int n, int npay, void* stream) {
  if (B < 1 || !qz_sort_shape_ok(n, npay)) return (int)cudaErrorInvalidValue;
  QzSortRow rows;
  rows.key = (uint32_t*)key;
  rows.pay[0] = (uint32_t*)p0;
  rows.pay[1] = (uint32_t*)p1;
  rows.pay[2] = (uint32_t*)p2;
  rows.pay[3] = (uint32_t*)p3;
  rows.npay = npay;
  uintptr_t addr = (uintptr_t)key;
  for (int q = 0; q < npay; ++q) addr |= (uintptr_t)rows.pay[q];
  if (addr & 15u) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (npay) {
    case 0: return qz_sort_run<0>(rows, B, (uint32_t)n, s);
    case 1: return qz_sort_run<1>(rows, B, (uint32_t)n, s);
    case 2: return qz_sort_run<2>(rows, B, (uint32_t)n, s);
    case 3: return qz_sort_run<3>(rows, B, (uint32_t)n, s);
    default: return qz_sort_run<4>(rows, B, (uint32_t)n, s);
  }
}

// The launch shape for rows of n keys with npay payloads: info[0] elements
// a CTA, [1] CTAs a cluster, [2] elements a cluster, [3] shared bytes a CTA,
// [4] the clusters the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int qz_sort_cluster_info(int n, int npay, int* info) {
  if (!qz_sort_shape_ok(n, npay)) return (int)cudaErrorInvalidValue;
  switch (npay) {
    case 0: return qz_sort_info<0>((uint32_t)n, info);
    case 1: return qz_sort_info<1>((uint32_t)n, info);
    case 2: return qz_sort_info<2>((uint32_t)n, info);
    case 3: return qz_sort_info<3>((uint32_t)n, info);
    default: return qz_sort_info<4>((uint32_t)n, info);
  }
}
