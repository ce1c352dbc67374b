// Lockstep DEFLATE entropy-decode kernel (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/pallas_inflate_kernel.py (kernel body _mk_kernel,
// compiled by _compiled, driven by decode_pallas).  The TPU kernel keeps
// 128 blocks in lockstep as vector lanes and builds every per-lane fetch
// from one-hot row reductions, superwindow refills and transposes, because
// Mosaic has no dynamic addressing.  Here one launch takes every lane of a
// round, a CTA a lane: its warp stages the lane's tables in shared memory,
// then one thread decodes (csrc/inflate_step.cuh).
//
// What bounds it on this card: latency, not bandwidth.  A round moves a
// few MB (streams, tables, tokens), microseconds of memory time, but each
// lane is a serial Huffman decode whose step is a chain of dependent table
// lookups, integer operations and branches, and a round lasts as long as
// its longest lane.  The design shortens the chain: shared-memory tables
// holding what the step would compute from an entry, the stream words in
// registers, a branch for each kind of symbol.  A warp of 32 lanes decoding
// in SIMT was measured slower (PERF.md): its lanes' stream words lie in 32
// different lines and its branches diverge, so every step waits for the
// slowest lane's memory and both sides of each branch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "inflate_step.cuh"

__global__ void __launch_bounds__(QZ_CTA_THREADS)
    qz_inflate_kernel(QzInflateArgs a, int32_t* __restrict__ nsteps) {
  __shared__ uint32_t smem[QZ_SMEM_WORDS];
  const int lane = blockIdx.x;
  qz_stage_tables(a, lane, threadIdx.x, smem);
  __syncthreads();
  // the round's step count is its slowest lane's (the reference's
  // while_loop runs until every lane is done)
  if (threadIdx.x == 0) atomicMax(nsteps, qz_inflate_lane(a, lane, smem));
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
  qz_inflate_kernel<<<lanes, QZ_CTA_THREADS, 0, (cudaStream_t)stream>>>(
      a, (int32_t*)nsteps);
  return (int)cudaGetLastError();
}
