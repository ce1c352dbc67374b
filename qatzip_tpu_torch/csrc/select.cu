// Candidate-select kernel for the hybrid match finder (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/pallas_select.py:select_candidates (kernel body
// _mk_kernel, neighbour shift _shift_right_lin).  The TPU kernel realises
// "the dd-back sorted neighbour" as lane + sublane rolls over a VMEM tile;
// here every thread owns one sorted record and reads its neighbours
// straight from device memory.
//
// What bounds it on this card: memory bandwidth.  A record reads 12 bytes
// of its own and re-reads up to depth neighbours that its warp's other
// threads also read, so the neighbour loads hit L1/L2; device memory sees
// about 12 bytes read and 4 written per record.  Neighbouring threads read
// neighbouring addresses, so every load is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

__global__ void qz_select_kernel(const uint32_t* __restrict__ sk,
                                 const uint32_t* __restrict__ sb4,
                                 const uint32_t* __restrict__ sb4b,
                                 int32_t* __restrict__ out, int64_t total,
                                 int n, int depth) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t row = i / n;
  const int j = (int)(i - row * n);
  const int64_t base = row * n;
  out[i] = qz_select_one(sk + base, sb4 + base, sb4b + base, j, depth);
}

extern "C" int qz_select_candidates(const void* sk, const void* sb4,
                                    const void* sb4b, void* out, int B,
                                    int n, int depth, void* stream) {
  const int threads = 256;
  const int64_t total = (int64_t)B * n;
  const int64_t blocks = (total + threads - 1) / threads;
  qz_select_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sk, (const uint32_t*)sb4, (const uint32_t*)sb4b,
      (int32_t*)out, total, n, depth);
  return (int)cudaGetLastError();
}

extern "C" const char* qz_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
