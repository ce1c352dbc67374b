// Compare-exchange logic of the bitonic u32 sort.
//
// The network of qatzip_tpu/ops/pallas_sort.py:_bitonic_body: stages
// k = 2, 4, .., n, and in each stage passes j = k/2, .., 1; the pass pairs
// element i with i ^ j and sorts the pair ascending when bit k of i is
// clear (descending otherwise).  Keys compare as uint32; payloads move with
// their key.  __host__ __device__ so that g++ builds the same functions for
// the CPU tests (tests/test_torch_csrc_host.py).
#pragma once
#include <stdint.h>

#define QZ_SORT_MAX_PAYLOADS 4
#define QZ_SORT_TILE 1024   // elements one thread block sorts in shared memory

// One row's arrays (or a tile of them), element 0 at index `base` of the row.
struct QzSortRow {
  uint32_t* key;
  uint32_t* pay[QZ_SORT_MAX_PAYLOADS];
  int npay;
  uint32_t base;
};

// The lower element of the p-th pair of a pass at stride j (j a power of 2):
// the p-th index whose bit j is clear.
__host__ __device__ inline uint32_t qz_bitonic_lower(uint32_t p, uint32_t j) {
  return ((p & ~(j - 1u)) << 1) | (p & (j - 1u));
}

// In stage k the pair whose lower element has row index i sorts ascending
// when bit k of i is clear.
__host__ __device__ inline bool qz_bitonic_ascending(uint32_t i, uint32_t k) {
  return (i & k) == 0u;
}

// The compare-exchange of the p-th pair of pass (k, j) on r.
__host__ __device__ inline void qz_bitonic_pair(const QzSortRow& r, uint32_t p,
                                                uint32_t j, uint32_t k) {
  const uint32_t lo = qz_bitonic_lower(p, j);
  const uint32_t hi = lo + j;
  const uint32_t a = r.key[lo];
  const uint32_t b = r.key[hi];
  const bool asc = qz_bitonic_ascending(r.base + lo, k);
  if (asc ? a > b : a < b) {
    r.key[lo] = b;
    r.key[hi] = a;
    // a constant trip count unrolls, so pay[] stays in registers
    for (int q = 0; q < QZ_SORT_MAX_PAYLOADS; ++q) {
      if (q >= r.npay) break;
      const uint32_t t = r.pay[q][lo];
      r.pay[q][lo] = r.pay[q][hi];
      r.pay[q][hi] = t;
    }
  }
}

// The row (or tile) r shifted to start at element off.
__host__ __device__ inline QzSortRow qz_sort_slice(const QzSortRow& r,
                                                   uint32_t off) {
  QzSortRow s = r;
  s.key = r.key + off;
  for (int q = 0; q < QZ_SORT_MAX_PAYLOADS; ++q)
    s.pay[q] = q < r.npay ? r.pay[q] + off : nullptr;
  s.base = r.base + off;
  return s;
}
