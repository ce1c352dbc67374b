// The select kernel without its shared-memory tile: a variant of
// csrc/select.cu for timing only.
//
// tools/select_bench.py builds it and times it beside the kernel the path
// runs.  A thread takes one record and reads its neighbours straight from
// device memory through L1, as the kernel's first design did, but with the
// path kernel's 2-D grid, template depth and early-exit look-back
// (csrc/select.cuh), so the two differ only in where the neighbours come
// from.  Same entry points and outputs as csrc/select.cu.  Not on any path
// of the port.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

template <int DEPTH, bool TO_POS>
__global__ void __launch_bounds__(QZ_SELECT_THREADS)
    qz_select_l1_kernel(QzSelectArgs a) {
  const int j = blockIdx.x * QZ_SELECT_THREADS + threadIdx.x;
  if (j >= a.n) return;
  const int64_t base = (int64_t)blockIdx.y * a.n;
  const int32_t d = qz_select_one<DEPTH>(a.sk + base, a.sb4 + base,
                                         a.sb4b + base, j, 0);
  if constexpr (TO_POS) {
    const int pos = (int)(a.sk[base + j] & 0xFFFFu);
    if (d != 0 && pos < a.n_full)
      ((uint16_t*)a.out)[(int64_t)blockIdx.y * a.n_full + pos] = (uint16_t)d;
  } else {
    ((int32_t*)a.out)[base + j] = d;
  }
}

template <bool TO_POS>
static int launch(const QzSelectArgs& a, int B, int depth, void* stream) {
  if (B < 1 || B > 65535 || a.n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.n + QZ_SELECT_THREADS - 1) / QZ_SELECT_THREADS, B);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (depth) {
    case 8:
      qz_select_l1_kernel<8, TO_POS><<<grid, QZ_SELECT_THREADS, 0, st>>>(a);
      break;
    case 12:
      qz_select_l1_kernel<12, TO_POS><<<grid, QZ_SELECT_THREADS, 0, st>>>(a);
      break;
    case 16:
      qz_select_l1_kernel<16, TO_POS><<<grid, QZ_SELECT_THREADS, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int qz_select_candidates(const void* sk, const void* sb4,
                                    const void* sb4b, void* out, int B,
                                    int n, int depth, void* stream) {
  const QzSelectArgs a = {(const uint32_t*)sk, (const uint32_t*)sb4,
                          (const uint32_t*)sb4b, out, n, n, 0};
  return launch<false>(a, B, depth, stream);
}

extern "C" int qz_select_to_positions(const void* sk, const void* sb4,
                                      const void* sb4b, void* out, int B,
                                      int n, int n_full, int depth,
                                      void* stream) {
  const QzSelectArgs a = {(const uint32_t*)sk, (const uint32_t*)sb4,
                          (const uint32_t*)sb4b, out, n, n_full, 0};
  return launch<true>(a, B, depth, stream);
}
