// Candidate select of the hybrid match finder: one CTA's tile of sorted
// records and each record's look-back over it.
//
// The logic of qatzip_tpu/ops/pallas_select.py:_mk_kernel (and of the XLA
// branch it is tested against, qatzip_tpu/ops/match_finder.py:134-162).
// __host__ __device__ so that g++ builds the same functions for the CPU
// tests (tests/test_torch_csrc_host.py), which run a launch's CTAs and
// threads one after another.
//
// PRECONDITION: every row is sorted ascending by its key, as sort 1 of
// ops/match_finder.py leaves it: valid keys h15 << 16 | pos16, unique in a
// row because positions are, then the invalid 0xFFFFFFFF.  On such rows the
// look-back stops early and still equals ops/select.select_candidates_ref:
//  * a neighbour with another hash ends it: every record further back has a
//    smaller key, so a smaller hash;
//  * a neighbour more than 32767 bytes back ends it: further back in one
//    hash run the positions fall, so the distance grows;
//  * an 8-byte prefix match ends it: it is the nearest such match, and it
//    outranks every 4- and 3-byte match.
// On rows that are not sorted the result is undefined.
#pragma once
#include <stdint.h>

#define QZ_SELECT_INVALID 0xFFFFFFFFu
#define QZ_SELECT_TOO_FAR 4096
// Tile shape (chip runs on the H100, PERF.md): 2 tiles of 512 records a CTA
// beat 1 or 4 tiles and 4 records a thread at both of the path's shapes.
#define QZ_SELECT_THREADS 256     // threads of a CTA
#define QZ_SELECT_PER_THREAD 2    // records a thread, QZ_SELECT_THREADS apart
#define QZ_SELECT_TILE (QZ_SELECT_THREADS * QZ_SELECT_PER_THREAD)
#define QZ_SELECT_HALO 16         // records staged before the tile: the
                                  // deepest look-back the kernel takes
#define QZ_SELECT_CTA_TILES 2     // consecutive tiles of a row a CTA takes
#define QZ_SELECT_SPAN (QZ_SELECT_HALO + QZ_SELECT_TILE)  // words an array
#define QZ_SELECT_SMEM_WORDS (3 * QZ_SELECT_SPAN)       // words a buffer

#ifdef __CUDACC__
typedef uint4 qz_u4;
#else
struct alignas(16) qz_u4 {
  uint32_t x, y, z, w;
};
#endif

struct QzSelectArgs {
  const uint32_t* sk;    // [B, n] sorted keys
  const uint32_t* sb4;   // [B, n] prefix bytes p..p+3
  const uint32_t* sb4b;  // [B, n] prefix bytes p+4..p+7
  void* out;             // int32 [B, n] in sorted order, or uint16
                         // [B, n_full] in position order, zeroed first
  int n;                 // records a row
  int n_full;            // columns of a position-order row
  int vec;               // n % 4 == 0 and the inputs 16-byte aligned
};

__host__ __device__ inline int qz_select_tiles(int n) {
  return (n + QZ_SELECT_TILE - 1) / QZ_SELECT_TILE;
}

// A 16-byte copy from device memory into shared memory: asynchronous on the
// card (cp.async, in flight until qz_copy_wait), a plain copy on the host.
__host__ __device__ inline void qz_copy16(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  *(qz_u4*)dst = *(const qz_u4*)src;
#endif
}

__host__ __device__ inline void qz_copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Thread t's share of staging a tile: the keys at sm[0, SPAN), sb4 at
// sm[SPAN, 2 SPAN), sb4b at sm[2 SPAN, 3 SPAN); record tile * TILE + i of
// the row lands at index HALO + i, after the QZ_SELECT_HALO records before
// the tile.  A row's first tile has no records before it: its halo holds
// invalid keys, whose hash 0xFFFF no valid key has, so every look-back stops
// there.  With a.vec the copies are 16-byte vectors, neighbouring threads on
// neighbouring vectors, and asynchronous: the caller waits for them with
// qz_copy_wait before a barrier (lo and n are multiples of 4 then, so a
// vector lies wholly before the row, wholly in it or wholly past its end);
// without, word by word.
__host__ __device__ inline void qz_select_stage(const QzSelectArgs& a,
                                                int row, int tile, int t,
                                                uint32_t* sm) {
  const int64_t base = (int64_t)row * a.n;
  const int lo = tile * QZ_SELECT_TILE - QZ_SELECT_HALO;  // record at sm[0]
  if (a.vec) {
    constexpr int V = QZ_SELECT_SPAN / 4;   // vectors an array
    for (int v = t; v < 3 * V; v += QZ_SELECT_THREADS) {
      const int arr = v / V;
      const int w = 4 * (v - arr * V);
      const uint32_t* src = arr == 0 ? a.sk : (arr == 1 ? a.sb4 : a.sb4b);
      uint32_t* dst = sm + arr * QZ_SELECT_SPAN + w;
      if (lo + w < 0) {
        const uint32_t fill = arr == 0 ? QZ_SELECT_INVALID : 0u;
        *(qz_u4*)dst = qz_u4{fill, fill, fill, fill};
      } else if (lo + w < a.n) {
        qz_copy16(dst, src + base + lo + w);
      }
    }
    return;
  }
  for (int v = t; v < 3 * QZ_SELECT_SPAN; v += QZ_SELECT_THREADS) {
    const int arr = v / QZ_SELECT_SPAN;
    const int i = lo + v - arr * QZ_SELECT_SPAN;
    const uint32_t* src = arr == 0 ? a.sk : (arr == 1 ? a.sb4 : a.sb4b);
    if (i < 0) {
      sm[v] = arr == 0 ? QZ_SELECT_INVALID : 0u;
    } else if (i < a.n) {
      sm[v] = src[base + i];
    }
  }
}

// The record at index s of the sorted arrays looks back at its neighbours
// s-1 .. s-DEPTH, none below index lo, and returns the nearest distance with
// an 8-byte prefix match, else the nearest 4-byte match, else the nearest
// 3-byte match closer than QZ_SELECT_TOO_FAR; 0 when there is none or the
// record is invalid.  A step loads the neighbour's three words together and
// takes one branch: the look-back's cost is the steps of a warp's longest.
template <int DEPTH>
__host__ __device__ inline int32_t qz_select_one(const uint32_t* sk,
                                                 const uint32_t* sb4,
                                                 const uint32_t* sb4b, int s,
                                                 int lo) {
  static_assert(DEPTH >= 1 && DEPTH <= QZ_SELECT_HALO,
                "the halo holds the look-back");
  const uint32_t key = sk[s];
  if (key == QZ_SELECT_INVALID) return 0;
  const uint32_t b4 = sb4[s];
  const uint32_t b4b = sb4b[s];
  // the distance grows with dd inside a hash run, so the first match of a
  // rank is its nearest, and the least distance of the rank
  uint32_t best8 = 0u, best4 = 0xFFFFFFFFu, best3 = 0xFFFFFFFFu;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int dd = 1; dd <= DEPTH && s - dd >= lo; ++dd) {
    const uint32_t ck = sk[s - dd];
    const uint32_t x = sb4[s - dd] ^ b4;
    const uint32_t y = sb4b[s - dd] ^ b4b;
    const uint32_t dist = key - ck;   // while the hash is the same
    // the end of the hash run, or beyond the window
    if ((key ^ ck) > 0xFFFFu || dist > 32767u) break;
    if (x == 0u) best4 = dist < best4 ? dist : best4;
    if ((x & 0xFFFFFFu) == 0u) best3 = dist < best3 ? dist : best3;
    if ((x | y) == 0u) {   // the nearest 8-byte match outranks the rest
      best8 = dist;
      break;
    }
  }
  if (best8 != 0u) return (int32_t)best8;
  if (best4 <= 32767u) return (int32_t)best4;
  return best3 < QZ_SELECT_TOO_FAR ? (int32_t)best3 : 0;
}

// Thread t of the CTA (tile, row) selects for records t, t + THREADS, ... of
// the staged tile, so a warp's lanes read consecutive shared-memory words,
// and stores each distance: in sorted order at the record's index, or in
// position order at column pos, where a valid record with a candidate
// stores its distance and no other record stores anything.
template <int DEPTH, bool TO_POS>
__host__ __device__ inline void qz_select_tile(const QzSelectArgs& a, int row,
                                               int tile, int t,
                                               const uint32_t* sm) {
  for (int r = 0; r < QZ_SELECT_PER_THREAD; ++r) {
    const int i = r * QZ_SELECT_THREADS + t;
    const int j = tile * QZ_SELECT_TILE + i;
    if (j >= a.n) return;
    // the halo makes every look-back readable: no lower bound
    const int s = QZ_SELECT_HALO + i;
    const int32_t d = qz_select_one<DEPTH>(sm, sm + QZ_SELECT_SPAN,
                                           sm + 2 * QZ_SELECT_SPAN, s,
                                           s - DEPTH);
    if constexpr (TO_POS) {
      const int pos = (int)(sm[QZ_SELECT_HALO + i] & 0xFFFFu);
      if (d != 0 && pos < a.n_full)   // d != 0: the key is valid
        ((uint16_t*)a.out)[(int64_t)row * a.n_full + pos] = (uint16_t)d;
    } else {
      ((int32_t*)a.out)[(int64_t)row * a.n + j] = d;
    }
  }
}
