// Device CRC32 / Adler-32 kernel (Hopper, sm_90a).
//
// Replaces qatzip_tpu/ops/checksums.py:91 (crc32_blocks) and :139
// (adler32_blocks), XLA code in the reference, whose plain torch port
// (qatzip_tpu_torch/ops/checksums.py) right-aligns every row and folds it
// with a log-depth tree of GF(2) matrix applies and a 25-step ladder, about
// 16 launches an apply and several hundred a call.  Here one launch takes
// every row: a CTA a row, each thread a contiguous slice of it
// (csrc/checksum.cuh), the slices' values combined by warp shuffles and a
// few words of shared memory.  Each CTA builds the slice-by-4 CRC tables in
// shared memory and copies the 25 zero-advance matrices there.
//
// What bounds it on this card: bytes, at the sizes the engines give it (a
// [128, 65536] batch is 8 MB, 2.5 us at the HBM rate), but a thread reads
// its slice a byte at a time (any row stride and alignment) and walks a
// chain of dependent table lookups; with a row a CTA a spec round's 8
// rows use 8 SMs.  A simple kernel that is right first.
#include <cuda_runtime.h>
#include <stdint.h>

#include "checksum.cuh"

__global__ void __launch_bounds__(QZ_CK_THREADS)
    qz_checksum_kernel(QzCkArgs a) {
  __shared__ uint32_t tab[QZ_CK_TAB];
  __shared__ uint32_t zadv[QZ_CK_ZADV * 32];
  __shared__ uint32_t red[2][QZ_CK_THREADS / 32];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int len = qz_ck_len(a, row);
  const uint8_t* p = a.data + row * a.stride;
  uint32_t v1 = 0, v2 = 0;
  if (a.kind == 0) {
    for (int k = 0; k < 4; ++k) {
      tab[256 * k + t] = qz_crc_tab_entry(tab, k, (uint32_t)t);
      __syncthreads();
    }
    for (int i = t; i < QZ_CK_ZADV * 32; i += QZ_CK_THREADS)
      zadv[i] = a.zadv[i];
    __syncthreads();
    v1 = qz_crc_part(tab, zadv, p, len, t);
    for (int o = 16; o > 0; o >>= 1) v1 ^= __shfl_xor_sync(0xFFFFFFFFu, v1, o);
  } else {
    qz_adler_part(p, len, t, &v1, &v2);
    for (int o = 16; o > 0; o >>= 1) {
      v1 += __shfl_xor_sync(0xFFFFFFFFu, v1, o);
      v2 += __shfl_xor_sync(0xFFFFFFFFu, v2, o);
    }
  }
  if (lane == 0) {
    red[0][warp] = v1;
    red[1][warp] = v2;
  }
  __syncthreads();
  if (t == 0) {
    uint32_t s1 = 0, s2 = 0;
    for (int w = 0; w < QZ_CK_THREADS / 32; ++w) {
      if (a.kind == 0) {
        s1 ^= red[0][w];
      } else {
        s1 += red[0][w];
        s2 += red[1][w];
      }
    }
    a.out[row] = (int64_t)(a.kind == 0 ? qz_crc_finish(zadv, s1, len)
                                       : qz_adler_finish(s1, s2, len));
  }
}

// out int64 [rows]: the CRC32 (kind 0) or Adler-32 (kind 1) of each row's
// first len[row] bytes (clamped to [0, n]), rows of data at stride bytes;
// zadv the [25][32] zero-advance matrix columns (read for CRC32 only).
extern "C" int qz_checksum(const void* data, long long stride,
                           const void* len, const void* zadv, void* out,
                           int rows, int n, int kind, void* stream) {
  if (rows < 1 || n < 0 || n >= (1 << QZ_CK_ZADV) || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const QzCkArgs a = {(const uint8_t*)data, (int64_t)stride,
                      (const int32_t*)len, (const uint32_t*)zadv,
                      (int64_t*)out, rows, n, kind};
  qz_checksum_kernel<<<rows, QZ_CK_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
