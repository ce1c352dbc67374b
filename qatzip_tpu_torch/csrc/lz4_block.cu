// LZ4 / LZ4s block-decode kernel (Hopper, sm_90a).
//
// Replaces the XLA decoder of qatzip_tpu/ops/lz4_decode.py:42
// (_decode_blocks_impl), ported as plain torch in
// qatzip_tpu_torch/ops/lz4_decode.py:67.  The TPU cannot chase a pointer a
// lane, so that design parses a sequence at every byte of a block, walks
// the chain by pointer doubling and resolves every output byte by
// log-doubling a source pointer: some 2.4 GB of tables for a group of 128
// blocks.  Here a warp walks one block's sequences directly and copies
// literals and matches with its 32 lanes (csrc/lz4_block.cuh); a group
// needs only its input and output arrays.
//
// What bounds it on this card: latency.  A group moves a few tens of MB, a
// few microseconds at the HBM rate, but a block is a chain of dependent
// sequences: each waits for its header's loads, then for its copies.  One
// warp a CTA spreads the blocks over the SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lz4_block.cuh"

// The lane's view of its warp, for qz_lz4_row.
struct QzWarp {
  int lane;
  template <class F>
  __device__ void each(F f) { f(lane); }
  __device__ void sync() { __syncwarp(); }
  template <class F>
  __device__ uint32_t ballot(F f) {
    return __ballot_sync(0xFFFFFFFFu, f(lane));
  }
};

__global__ void __launch_bounds__(QZ_LZ4_LANES) qz_lz4_kernel(QzLz4Args a) {
  QzWarp w{(int)threadIdx.x};
  qz_lz4_row(a, blockIdx.x, w);
}

extern "C" int qz_lz4_decode(const void* in, const void* len, void* out,
                             void* tot, void* err, int rows, int n,
                             int outcap, int lz4s, int base, void* stream) {
  const QzLz4Args a = {(const uint8_t*)in, (const int32_t*)len, rows, n,
                       outcap, lz4s, base, (uint8_t*)out, (int32_t*)tot,
                       (uint8_t*)err};
  qz_lz4_kernel<<<rows, QZ_LZ4_LANES, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
