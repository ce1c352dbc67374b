// Lockstep DEFLATE entropy-decode kernel (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/pallas_inflate_kernel.py (kernel body _mk_kernel,
// compiled by _compiled, driven by decode_pallas).  The TPU kernel keeps
// 128 blocks in lockstep as vector lanes and builds every per-lane fetch
// from one-hot row reductions, superwindow refills and transposes, because
// Mosaic has no dynamic addressing.  Here one thread owns one lane and runs
// the step of csrc/inflate_step.cuh in a loop, reading its stream words
// and table cells straight from device memory.
//
// What bounds it on this card: latency, not bandwidth.  Each step is a
// chain of dependent loads (stream peek -> litlen root -> subtable ->
// distance root -> subtable -> paired-literal root), and one round is at
// most 128 lanes, so the card runs 128 threads on 132 SMs.  The design
// launches one lane per thread block, which spreads the lanes over as many
// SMs as there are lanes, so that each lane's tables have an L1 to
// themselves (4 and 32 lanes a block measured slower); widening the round
// beyond 128 lanes is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "inflate_step.cuh"

__global__ void qz_inflate_kernel(const uint32_t* __restrict__ words, int nw,
                                  const int32_t* __restrict__ bit0,
                                  const int32_t* __restrict__ nbits,
                                  const uint32_t* __restrict__ tll,
                                  const uint32_t* __restrict__ td,
                                  const int32_t* __restrict__ active,
                                  int lanes, int max_steps,
                                  uint32_t* __restrict__ tokens,
                                  int32_t* __restrict__ err,
                                  int32_t* __restrict__ outcnt,
                                  int32_t* __restrict__ end_bit,
                                  int32_t* __restrict__ nsteps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const QzLane L = {words + (int64_t)lane * nw, nw,
                    tll + (int64_t)lane * QZ_CELLS,
                    td + (int64_t)lane * QZ_CELLS};
  const int s = qz_inflate_lane(L, bit0[lane], nbits[lane], active[lane] != 0,
                                max_steps, tokens, lanes, lane, err + lane,
                                outcnt + lane, end_bit + lane);
  // the round's step count is its slowest lane's (the reference's
  // while_loop runs until every lane is done)
  atomicMax(nsteps, s);
}

extern "C" int qz_inflate_decode(const void* words, const void* bit0,
                                 const void* nbits, const void* tll,
                                 const void* td, const void* active,
                                 void* tokens, void* err, void* outcnt,
                                 void* end_bit, void* nsteps, int lanes,
                                 int nw, int max_steps, void* stream) {
  qz_inflate_kernel<<<lanes, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, nw, (const int32_t*)bit0,
      (const int32_t*)nbits, (const uint32_t*)tll, (const uint32_t*)td,
      (const int32_t*)active, lanes, max_steps, (uint32_t*)tokens,
      (int32_t*)err, (int32_t*)outcnt, (int32_t*)end_bit, (int32_t*)nsteps);
  return (int)cudaGetLastError();
}
