// A warp of lanes a CTA: a variant of csrc/inflate.cu for timing only.
//
// tools/inflate_bench.py builds it with -DQZ_WARP_LANES=W and times it
// beside the kernel the path runs (one lane a CTA).  Here a CTA is one warp
// that takes W lanes, one lane a thread, so the W lanes decode in SIMT and
// the token stores of a step from one warp fall on consecutive words.  The
// warp stages every lane's widened entries into the CTA's shared memory
// (8 KB a lane, contiguous) and each thread then runs the same lane loop and
// step as the path (csrc/inflate_step.cuh), so the outputs are the path
// kernel's.  32 lanes would need 256 KB of shared memory, more than a CTA
// may hold (227 KB), so W is at most 27.  Not on any path of the port.
#include <cuda_runtime.h>
#include <stdint.h>

#include "inflate_step.cuh"

#ifndef QZ_WARP_LANES
#define QZ_WARP_LANES 16
#endif
#define QZ_WARP_SMEM_BYTES (QZ_WARP_LANES * QZ_SMEM_WORDS * 4)
static_assert(QZ_WARP_LANES >= 1 && QZ_WARP_LANES <= QZ_CTA_THREADS,
              "a CTA is one warp");
static_assert(QZ_WARP_SMEM_BYTES <= 227 * 1024,
              "a CTA holds at most 227 KB of shared memory");

__global__ void __launch_bounds__(QZ_CTA_THREADS)
    qz_inflate_warp_kernel(QzInflateArgs a, int32_t* __restrict__ nsteps) {
  extern __shared__ uint32_t smem[];
  const int lane0 = blockIdx.x * QZ_WARP_LANES;
  for (int i = 0; i < QZ_WARP_LANES && lane0 + i < a.lanes; ++i)
    qz_stage_tables(a, lane0 + i, threadIdx.x, smem + i * QZ_SMEM_WORDS);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < QZ_WARP_LANES && lane0 + t < a.lanes)
    atomicMax(nsteps, qz_inflate_lane(a, lane0 + t,
                                      smem + t * QZ_SMEM_WORDS));
}

extern "C" int qz_inflate_decode(const void* words, const void* bit0,
                                 const void* nbits, const void* tll,
                                 const void* td, const void* active,
                                 void* tokens, void* err, void* outcnt,
                                 void* end_bit, void* nsteps, int lanes,
                                 int nw, int max_steps, void* stream) {
  const QzInflateArgs a = {
      (const uint32_t*)words, nw,          (const int32_t*)bit0,
      (const int32_t*)nbits,  (const uint32_t*)tll, (const uint32_t*)td,
      (const int32_t*)active, lanes,       max_steps,
      (uint32_t*)tokens,      (int32_t*)err, (int32_t*)outcnt,
      (int32_t*)end_bit};
  const cudaError_t rc = cudaFuncSetAttribute(
      qz_inflate_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QZ_WARP_SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  const int ctas = (lanes + QZ_WARP_LANES - 1) / QZ_WARP_LANES;
  qz_inflate_warp_kernel<<<ctas, QZ_CTA_THREADS, QZ_WARP_SMEM_BYTES,
                           (cudaStream_t)stream>>>(a, (int32_t*)nsteps);
  return (int)cudaGetLastError();
}
