// Candidate-select kernel for the hybrid match finder (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/pallas_select.py:select_candidates (kernel body
// _mk_kernel, neighbour shift _shift_right_lin), which realises "the dd-back
// sorted neighbour" as lane and sublane rolls over a VMEM tile, and, in the
// position-order entry, the second sort of qatzip_tpu/ops/match_finder.py
// (:164-179) that puts the distances back in position order.
//
// What bounds it on this card: memory bandwidth.  Each record is read once
// (12 bytes) and its distance written once (4 bytes in sorted order, or 2
// bytes at its column of a zeroed position-order row); the look-back does a
// few integer operations for each neighbour it visits.  On the H100 the
// staging alone comes within 80% of that bound, and the look-back's
// dependent steps, a warp as long as its longest lane, set the time
// (PERF.md).  The design:
//  * a 2-D grid, blockIdx.y the row and blockIdx.x the tile, so no thread
//    divides;
//  * a CTA takes 2 consecutive tiles of 512 records of one row.  It stages
//    a tile of the three arrays, and the 16 records before it, into shared
//    memory with coalesced 16-byte loads (select.cuh), so every record is
//    read from device memory once, not once by each of the depth records
//    that look back at it.  Two buffers: the next tile's copies are in
//    flight (cp.async, no registers held) while the CTA selects over the
//    current one, so the loads and the look-back overlap;
//  * a thread takes 2 records of the tile, 256 apart, so a warp reads 32
//    consecutive shared-memory words (no bank conflict);
//  * the depth is a template parameter (8, 12 or 16, the depths the path
//    uses, and 4, the match finder's default depth), so the look-back
//    unrolls, and it stops at the end of the hash
//    run, at a distance past 32767 or at the nearest 8-byte match, exact on
//    rows sorted as sort 1 leaves them (select.cuh);
//  * the position-order entry stores each distance straight to its column:
//    positions are unique in a row, so no atomics, and the three torch
//    passes after the select (an index where, a scatter, a cast) go.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

// 8 CTAs a SM (2048 threads, 32 registers each, 200 KB of shared memory):
// the look-back is latency-bound, and the position-order entry left to
// itself takes 40 registers and 6 CTAs (PERF.md)
template <int DEPTH, bool TO_POS>
__global__ void __launch_bounds__(QZ_SELECT_THREADS, 8)
    qz_select_kernel(QzSelectArgs a) {
  __shared__ __align__(16) uint32_t sm[2][QZ_SELECT_SMEM_WORDS];
  const int row = blockIdx.y;
  const int t = threadIdx.x;
  const int first = blockIdx.x * QZ_SELECT_CTA_TILES;
  const int end = min(first + QZ_SELECT_CTA_TILES, qz_select_tiles(a.n));
  qz_select_stage(a, row, first, t, sm[0]);
  qz_copy_wait();
  __syncthreads();
  for (int tile = first; tile < end; ++tile) {
    // the next tile's copies fly while the CTA selects over this one; the
    // buffer they fill was last read in the tile before, behind a barrier
    if (tile + 1 < end)
      qz_select_stage(a, row, tile + 1, t, sm[(tile - first + 1) & 1]);
    qz_select_tile<DEPTH, TO_POS>(a, row, tile, t, sm[(tile - first) & 1]);
    qz_copy_wait();
    __syncthreads();
  }
}

template <bool TO_POS>
static int qz_select_launch(const QzSelectArgs& a, int B, int depth,
                            void* stream) {
  if (B < 1 || B > 65535 || a.n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(
      (qz_select_tiles(a.n) + QZ_SELECT_CTA_TILES - 1) / QZ_SELECT_CTA_TILES,
      B);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (depth) {
    case 4:
      qz_select_kernel<4, TO_POS><<<grid, QZ_SELECT_THREADS, 0, st>>>(a);
      break;
    case 8:
      qz_select_kernel<8, TO_POS><<<grid, QZ_SELECT_THREADS, 0, st>>>(a);
      break;
    case 12:
      qz_select_kernel<12, TO_POS><<<grid, QZ_SELECT_THREADS, 0, st>>>(a);
      break;
    case 16:
      qz_select_kernel<16, TO_POS><<<grid, QZ_SELECT_THREADS, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

static int qz_select_vec(const void* sk, const void* sb4, const void* sb4b,
                         int n) {
  const uintptr_t bits = (uintptr_t)sk | (uintptr_t)sb4 | (uintptr_t)sb4b;
  return (n % 4 == 0) && (bits % 16 == 0);
}

// int32 [B, n] distances in sorted order.
extern "C" int qz_select_candidates(const void* sk, const void* sb4,
                                    const void* sb4b, void* out, int B,
                                    int n, int depth, void* stream) {
  const QzSelectArgs a = {(const uint32_t*)sk, (const uint32_t*)sb4,
                          (const uint32_t*)sb4b, out, n, n,
                          qz_select_vec(sk, sb4, sb4b, n)};
  return qz_select_launch<false>(a, B, depth, stream);
}

// uint16 [B, n_full] distances in position order; out must be zeroed.
extern "C" int qz_select_to_positions(const void* sk, const void* sb4,
                                      const void* sb4b, void* out, int B,
                                      int n, int n_full, int depth,
                                      void* stream) {
  const QzSelectArgs a = {(const uint32_t*)sk, (const uint32_t*)sb4,
                          (const uint32_t*)sb4b, out, n, n_full,
                          qz_select_vec(sk, sb4, sb4b, n)};
  return qz_select_launch<true>(a, B, depth, stream);
}

extern "C" const char* qz_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
