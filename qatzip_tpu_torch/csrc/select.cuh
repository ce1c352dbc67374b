// Per-record candidate select of the hybrid match finder.
//
// The logic of qatzip_tpu/ops/pallas_select.py:_mk_kernel (and of the XLA
// branch it is tested against, qatzip_tpu/ops/match_finder.py:134-162) for
// ONE hash-sorted record.  __host__ __device__ so that g++ builds the same
// function for the CPU tests (tests/test_torch_csrc_host.py).
#pragma once
#include <stdint.h>

#define QZ_SELECT_INVALID 0xFFFFFFFFu
#define QZ_SELECT_TOO_FAR 4096

// sk/sb4/sb4b point at the start of one block's sorted arrays: key
// h15 << 16 | pos16 (0xFFFFFFFF = invalid), prefix bytes p..p+3 and
// p+4..p+7.  Looks back at the sorted neighbours j-1 .. j-depth and returns
// the nearest distance with an 8-byte prefix match, else the nearest 4-byte
// match, else the nearest 3-byte match closer than QZ_SELECT_TOO_FAR; 0 when
// there is none.
__host__ __device__ inline int32_t qz_select_one(const uint32_t* sk,
                                                 const uint32_t* sb4,
                                                 const uint32_t* sb4b,
                                                 int j, int depth) {
  const uint32_t key = sk[j];
  if (key == QZ_SELECT_INVALID) return 0;
  const int32_t cur_pos = (int32_t)(key & 0xFFFFu);
  const uint32_t cur_h = key >> 16;
  const uint32_t b4 = sb4[j];
  const uint32_t b4b = sb4b[j];
  int32_t best8 = 0, best4 = 0, best3 = 0;
  for (int dd = 1; dd <= depth && dd <= j; ++dd) {
    const uint32_t ck = sk[j - dd];
    if (ck == QZ_SELECT_INVALID || (ck >> 16) != cur_h) continue;
    const int32_t dist = cur_pos - (int32_t)(ck & 0xFFFFu);
    if (dist < 1 || dist > 32767) continue;
    const uint32_t cb4 = sb4[j - dd];
    const bool eq4 = cb4 == b4;
    const bool eq8 = eq4 && sb4b[j - dd] == b4b;
    const bool eq3 = ((cb4 ^ b4) & 0xFFFFFFu) == 0u;
    // nearest first within each rank: dd ascends with distance in a chain
    if (best8 == 0 && eq8) best8 = dist;
    if (best4 == 0 && eq4) best4 = dist;
    if (best3 == 0 && eq3) best3 = dist;
  }
  if (best3 >= QZ_SELECT_TOO_FAR) best3 = 0;
  return best8 > 0 ? best8 : (best4 > 0 ? best4 : best3);
}
