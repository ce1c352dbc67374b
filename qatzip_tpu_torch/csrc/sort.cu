// Bitonic sort of u32 keys with up to 4 payloads (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/pallas_sort.py:sort_u32 (kernel body _mk_kernel,
// network _bitonic_body, partner roll _partner).  The TPU kernel keeps a
// whole [S, 128] row in VMEM and realises each partner as a lane or sublane
// roll.  A row of up to 64 K keys and payloads does not fit one SM's shared
// memory, so here the network runs in two kinds of launch:
//
//   * qz_sort_tile_kernel: one thread block loads a tile of QZ_SORT_TILE
//     elements into shared memory and runs every pass whose stride is below
//     the tile (all stages k <= QZ_SORT_TILE at first, then the tail j <
//     QZ_SORT_TILE of each later stage), one thread a pair;
//   * qz_sort_pass_kernel: one pass (k, j) with j >= QZ_SORT_TILE over
//     device memory, one thread a pair.
//
// What bounds it on this card: device memory.  A global pass reads and
// writes every key and payload once; a [128, 65536] sort with 2 payloads
// runs 21 of them plus 7 tile launches, each reading and writing 100 MB,
// about 5.6 GB in all (1.7 ms at 3.35 TB/s).  Pairs of a warp touch
// neighbouring addresses, so loads are coalesced.  Fewer
// global passes (larger tiles, registers for the last strides) are later
// work.  The compare-exchange logic is csrc/sort.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort.cuh"

__global__ void __launch_bounds__(QZ_SORT_TILE / 2)
    qz_sort_tile_kernel(QzSortRow rows, int n, uint32_t k_merge) {
  __shared__ uint32_t s_key[QZ_SORT_TILE];
  __shared__ uint32_t s_pay[QZ_SORT_MAX_PAYLOADS][QZ_SORT_TILE];
  const int tiles = n / QZ_SORT_TILE;
  const uint32_t off = (uint32_t)(blockIdx.x % tiles) * QZ_SORT_TILE;
  const int64_t start = (int64_t)(blockIdx.x / tiles) * n + off;
  QzSortRow t;
  t.key = s_key;
  t.npay = rows.npay;
  t.base = off;
  for (int q = 0; q < QZ_SORT_MAX_PAYLOADS; ++q) t.pay[q] = s_pay[q];
  for (int e = threadIdx.x; e < QZ_SORT_TILE; e += blockDim.x) {
    s_key[e] = rows.key[start + e];
    for (int q = 0; q < QZ_SORT_MAX_PAYLOADS; ++q)
      if (q < rows.npay) s_pay[q][e] = rows.pay[q][start + e];
  }
  __syncthreads();
  // k_merge == 0: stages 2 .. QZ_SORT_TILE in full; otherwise the passes
  // j < QZ_SORT_TILE of stage k_merge
  const uint32_t k_lo = k_merge ? k_merge : 2u;
  const uint32_t k_hi = k_merge ? k_merge : (uint32_t)QZ_SORT_TILE;
  for (uint32_t k = k_lo; k <= k_hi; k <<= 1) {
    for (uint32_t j = k_merge ? QZ_SORT_TILE / 2 : k / 2; j >= 1; j >>= 1) {
      qz_bitonic_pair(t, threadIdx.x, j, k);
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < QZ_SORT_TILE; e += blockDim.x) {
    rows.key[start + e] = s_key[e];
    for (int q = 0; q < QZ_SORT_MAX_PAYLOADS; ++q)
      if (q < rows.npay) rows.pay[q][start + e] = s_pay[q][e];
  }
}

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

// Sorts B rows of n keys (n a power of 2 and a multiple of QZ_SORT_TILE) in
// place, ascending in uint32 order, moving npay payload rows with them.
extern "C" int qz_sort_u32(void* key, void* p0, void* p1, void* p2, void* p3,
                           int B, int n, int npay, void* stream) {
  if (B < 1 || n < QZ_SORT_TILE || n % QZ_SORT_TILE || (n & (n - 1)) ||
      npay < 0 || npay > QZ_SORT_MAX_PAYLOADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  QzSortRow rows;
  rows.key = (uint32_t*)key;
  rows.pay[0] = (uint32_t*)p0;
  rows.pay[1] = (uint32_t*)p1;
  rows.pay[2] = (uint32_t*)p2;
  rows.pay[3] = (uint32_t*)p3;
  rows.npay = npay;
  rows.base = 0;
  const unsigned tiles = (unsigned)B * (unsigned)(n / QZ_SORT_TILE);
  const int64_t pairs = (int64_t)B * (n / 2);
  const int threads = 256;
  const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
  qz_sort_tile_kernel<<<tiles, QZ_SORT_TILE / 2, 0, s>>>(rows, n, 0u);
  cudaError_t err = cudaGetLastError();
  for (uint32_t k = 2u * QZ_SORT_TILE; err == cudaSuccess && k <= (uint32_t)n;
       k <<= 1) {
    for (uint32_t j = k / 2; err == cudaSuccess && j >= QZ_SORT_TILE;
         j >>= 1) {
      qz_sort_pass_kernel<<<blocks, threads, 0, s>>>(rows, n, pairs, k, j);
      err = cudaGetLastError();
    }
    if (err == cudaSuccess) {
      qz_sort_tile_kernel<<<tiles, QZ_SORT_TILE / 2, 0, s>>>(rows, n, k);
      err = cudaGetLastError();
    }
  }
  return (int)err;
}
