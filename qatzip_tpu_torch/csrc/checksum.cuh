// Device CRC32 and Adler-32 of a batch of rows: one thread's share of a
// row, and the joins of the shares.
//
// The function of qatzip_tpu/ops/checksums.py:91 (crc32_blocks) and :139
// (adler32_blocks), ported as plain torch in
// qatzip_tpu_torch/ops/checksums.py: the zlib-convention checksum of
// data[b, :len[b]].
//
// The slicing (qz_ck_plan, qz_ck_slice): P CTAs a row (a cluster), T
// threads a CTA, a slice of s bytes a thread, so Q = P T slices a row, all
// powers of 2; the slices span N = Q s >= n bytes, right-aligned to E = len
// rounded up to 8.  Thread t of CTA r takes slice q = r T + t, bytes
// [E - N + q s, E - N + (q + 1) s).  Bytes before the row's start and at
// or past len read as zeros: every slice starts and ends on a multiple of
// 8 bytes, and a word lies wholly before the row or in [0, E).
//  * CRC32: a slice-by-8 table CRC of each slice with a zero register, the
//    init 0xFFFFFFFF joined at the row's byte 0 (leading zeros leave a zero
//    register at 0); the slices' registers join in a fixed tree, each join
//    crc(L || R) = Z(|R|)(crc L) ^ crc R with Z(m) the "advance by m zero
//    bytes" matrix, a power of 2 of bytes at every join; the tree gives the
//    register after E bytes, len's register advanced over E - len < 8
//    zero bytes, which one of the QZ_CK_UNPAD inverse matrices undoes;
//  * Adler-32: each slice's sums s1 = sum(d) and s2 = sum((e - i) * d_i)
//    (e the slice's end), reduced mod 65521 every QZ_CK_WORDS words so
//    that no u32 overflows; the row's B is len + the sum of (E - e) * s1 +
//    s2 over the slices, less (E - len) * A's sum.
//
// The tables (ops/checksums._kernel_tables, built once a device): the
// slice-by-8 tables, the zero-advance matrices' columns and the inverse
// matrices, QZ_CK_TABLE_WORDS words.
//
// __host__ __device__ so that g++ builds the same functions for the CPU
// tests (tests/test_torch_csrc_host.py), which run a launch's CTAs and
// threads one after another.  Lengths are clamped to [0, n]; the callers
// pass lengths of at most n.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define QZ_CK_UNROLL_ALL _Pragma("unroll")
#else
#define QZ_CK_UNROLL_ALL
#endif

#define QZ_CK_THREADS 256      // T: threads a CTA
#define QZ_CK_WORDS 8          // words of a slice loaded at once
#define QZ_CK_CLUSTER_MAX 8    // P at most: CTAs a row, a cluster
#define QZ_CK_TARGET 132       // CTAs a launch aims at: one an SM
#define QZ_CK_MIN_PIECE 4096   // bytes of n a CTA at least
#define QZ_CK_ZADV 25          // zero-advance matrices: 2^0 .. 2^24 bytes
#define QZ_CK_UNPAD 8          // inverse advances over 0 .. 7 zero bytes
// the tables' layout (words): the slice-by-8 tables, the zero-advance
// matrices' columns, the inverse advances' columns
#define QZ_CK_TAB 2048
#define QZ_CK_UNPAD_AT (QZ_CK_TAB + 32 * QZ_CK_ZADV)
#define QZ_CK_TABLE_WORDS (QZ_CK_UNPAD_AT + 32 * QZ_CK_UNPAD)
#define QZ_ADLER_MOD 65521u

struct QzCkArgs {
  const uint8_t* data;     // row b at data + b * stride
  int64_t stride;
  const void* len;         // [rows] int32, or int64 where len64
  int len64;
  const uint32_t* tables;  // QZ_CK_TABLE_WORDS
  int64_t* out;            // [rows] u32 checksums
  int rows, n;
  int kind;                // 0 CRC32, 1 Adler-32
};

// The slicing of a launch: p CTAs a row, slices of 2^s_lg bytes spanning
// 2^n_lg bytes a row.
struct QzCkPlan {
  int p, p_lg, s_lg, n_lg;
};

__host__ __device__ inline int qz_ck_log2(int64_t v) {
  int k = 0;
  while (((int64_t)1 << k) < v) ++k;
  return k;
}

// The slicing for p CTAs a row (a power of 2) and rows of up to n bytes.
__host__ __device__ inline QzCkPlan qz_ck_plan_p(int p, int n) {
  QzCkPlan pl;
  pl.p = p;
  pl.p_lg = qz_ck_log2(p);
  const int64_t least = (int64_t)p * QZ_CK_THREADS * 8;
  const int64_t need = ((int64_t)n + 7) & ~(int64_t)7;
  pl.n_lg = qz_ck_log2(need > least ? need : least);
  pl.s_lg = pl.n_lg - pl.p_lg - qz_ck_log2(QZ_CK_THREADS);
  return pl;
}

// The launch's slicing: CTAs a row doubled while the launch stays within
// QZ_CK_TARGET CTAs and each CTA keeps QZ_CK_MIN_PIECE bytes of n (a spec
// round's 8 rows of 64 KB: 8 CTAs a row; an encoder batch's 128 rows: 1,
// a plain launch with no cluster to join over).
__host__ __device__ inline QzCkPlan qz_ck_plan(int rows, int n) {
  int p = 1;
  while (p < QZ_CK_CLUSTER_MAX && (int64_t)2 * p * rows <= QZ_CK_TARGET &&
         (int64_t)2 * p * QZ_CK_MIN_PIECE <= n)
    p *= 2;
  return qz_ck_plan_p(p, n);
}

__host__ __device__ inline int qz_ck_len(const QzCkArgs& a, int row) {
  const int64_t len = a.len64 ? ((const int64_t*)a.len)[row]
                              : ((const int32_t*)a.len)[row];
  return len < 0 ? 0 : len > a.n ? a.n : (int)len;
}

__host__ __device__ inline int qz_ck_end(int len) { return (len + 7) & ~7; }

// The first byte (relative to the row's start; negative before it) of
// thread t of CTA r's slice, for a row whose slices end at E.
__host__ __device__ inline int64_t qz_ck_slice(const QzCkPlan& pl, int E,
                                               int r, int t) {
  const int64_t q = (int64_t)r * QZ_CK_THREADS + t;
  return (int64_t)E - ((int64_t)1 << pl.n_lg) + (q << pl.s_lg);
}

// The 8 bytes at p, little-endian: one load on the card, where p is
// 8-byte aligned.
__host__ __device__ inline uint64_t qz_ck_load8(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *(const uint64_t*)p;
#else
  uint64_t v = 0;
  for (int k = 0; k < 8; ++k) v |= (uint64_t)p[k] << (8 * k);
  return v;
#endif
}

// The 8 bytes at row + o, little-endian, those at or past len zero (o a
// multiple of 8 in [0, E)), a byte at a time, never past len.
__host__ __device__ inline uint64_t qz_ck_word(const uint8_t* row, int64_t o,
                                               int len) {
  const int64_t m = len - o < 8 ? len - o : 8;
  uint64_t v = 0;
  for (int k = 0; k < m; ++k) v |= (uint64_t)row[o + k] << (8 * k);
  return v;
}

// The register c after the 8 bytes of w (slice-by-8: table j holds the
// register after a byte and j zero bytes).
__host__ __device__ inline uint32_t qz_crc_step8(const uint32_t* tab,
                                                 uint32_t c, uint64_t w) {
  const uint32_t lo = (uint32_t)w ^ c, hi = (uint32_t)(w >> 32);
  return tab[1792 + (lo & 0xFFu)] ^ tab[1536 + ((lo >> 8) & 0xFFu)] ^
         tab[1280 + ((lo >> 16) & 0xFFu)] ^ tab[1024 + (lo >> 24)] ^
         tab[768 + (hi & 0xFFu)] ^ tab[512 + ((hi >> 8) & 0xFFu)] ^
         tab[256 + ((hi >> 16) & 0xFFu)] ^ tab[hi >> 24];
}

// A GF(2) 32x32 matrix (its columns) applied to v: the columns' loads all
// issued at once, four partial sums.
__host__ __device__ inline uint32_t qz_gf2_apply(const uint32_t* cols,
                                                 uint32_t v) {
  uint32_t acc[4] = {0, 0, 0, 0};
  QZ_CK_UNROLL_ALL
  for (int b = 0; b < 32; ++b)
    acc[b & 3] ^= cols[b] & (0u - ((v >> b) & 1u));
  return acc[0] ^ acc[1] ^ acc[2] ^ acc[3];
}

// crc(L || R) from crc L and crc R, R 2^k bytes long: zadv the
// zero-advance matrices' columns.
__host__ __device__ inline uint32_t qz_crc_join(const uint32_t* zadv, int k,
                                                uint32_t l, uint32_t r) {
  return qz_gf2_apply(zadv + 32 * k, l) ^ r;
}

// One word of a slice at byte o of the row: the register or the sums
// after it (qz_ck_thread).
__host__ __device__ inline void qz_ck_step(const uint32_t* tab, int kind,
                                           int64_t o, uint64_t w,
                                           uint32_t* a, uint32_t* b) {
  if (kind == 0) {
    *a = qz_crc_step8(tab, *a ^ (o == 0 ? 0xFFFFFFFFu : 0u), w);
    return;
  }
#ifdef __CUDA_ARCH__
  const uint32_t lo = (uint32_t)w, hi = (uint32_t)(w >> 32);
  const uint32_t sum = __dp4a(lo, 0x01010101u, __dp4a(hi, 0x01010101u, 0u));
  const uint32_t wsum = __dp4a(lo, 0x05060708u, __dp4a(hi, 0x01020304u, 0u));
#else
  uint32_t sum = 0, wsum = 0;
  for (int k = 0; k < 8; ++k) {
    const uint32_t d = (uint32_t)(w >> (8 * k)) & 0xFFu;
    sum += d;
    wsum += (uint32_t)(8 - k) * d;
  }
#endif
  *b += 8 * *a + wsum;
  *a += sum;
}

// Thread t of CTA r's slice of a row of len bytes: its CRC32 register
// (kind 0, into *c) or its Adler sums (kind 1; s1 into *c, s2 weighted to
// the row's E into *c2).  On a row that is 8-byte aligned the slice's whole
// words take 8-byte loads, QZ_CK_WORDS at once and the next QZ_CK_WORDS in
// flight while these are used, no branch between them; the row's last
// word, where it is partial, and every word of a row at another alignment,
// qz_ck_word's byte loads.  Words before the row are skipped (zeros leave
// a zero register and zero sums).
__host__ __device__ inline void qz_ck_thread(const QzCkPlan& pl,
                                             const uint32_t* tab, int kind,
                                             const uint8_t* row, int len,
                                             int r, int t, uint32_t* c,
                                             uint32_t* c2) {
  const int E = qz_ck_end(len);
  const int s = 1 << pl.s_lg;
  const int64_t o0 = qz_ck_slice(pl, E, r, t);
  const int i0 = o0 < 0 ? (int)(-o0 < s ? -o0 : s) : 0;
  // [i0, whole): the slice's whole words (relative to o0)
  int whole = i0;
  if (((uintptr_t)row & 7u) == 0) {
    const int64_t in_row = (len - o0) & ~(int64_t)7;
    whole = in_row < i0 ? i0 : in_row > s ? s : (int)in_row;
  }
  uint32_t a = 0, b = 0;
  uint64_t w[QZ_CK_WORDS], next[QZ_CK_WORDS];
  QZ_CK_UNROLL_ALL
  for (int u = 0; u < QZ_CK_WORDS; ++u)
    w[u] = i0 + 8 * u < whole ? qz_ck_load8(row + o0 + i0 + 8 * u) : 0;
  for (int i = i0; i < whole; i += 8 * QZ_CK_WORDS) {
    const int j = i + 8 * QZ_CK_WORDS;
    QZ_CK_UNROLL_ALL
    for (int u = 0; u < QZ_CK_WORDS; ++u)
      next[u] = j + 8 * u < whole ? qz_ck_load8(row + o0 + j + 8 * u) : 0;
    QZ_CK_UNROLL_ALL
    for (int u = 0; u < QZ_CK_WORDS; ++u)
      if (i + 8 * u < whole) qz_ck_step(tab, kind, o0 + i + 8 * u, w[u], &a, &b);
    if (kind == 1) {   // QZ_CK_WORDS words since the last reduction
      a %= QZ_ADLER_MOD;
      b %= QZ_ADLER_MOD;
    }
    QZ_CK_UNROLL_ALL
    for (int u = 0; u < QZ_CK_WORDS; ++u) w[u] = next[u];
  }
  for (int i = whole; i < s; i += 8) {
    qz_ck_step(tab, kind, o0 + i, qz_ck_word(row, o0 + i, len), &a, &b);
    if (kind == 1) {
      a %= QZ_ADLER_MOD;
      b %= QZ_ADLER_MOD;
    }
  }
  if (kind == 1) {   // E - (o0 + s) < 2^25; products below 2^32
    const uint32_t tail = (uint32_t)(E - (o0 + s)) % QZ_ADLER_MOD;
    b = (b + tail * a % QZ_ADLER_MOD) % QZ_ADLER_MOD;
  }
  *c = a;
  *c2 = b;
}

// The row's CRC32 from the tree's register after E bytes: the trailing
// E - len zero bytes undone, complemented; 0 for an empty row.
__host__ __device__ inline uint32_t qz_crc_finish(const uint32_t* unpad,
                                                  uint32_t R, int len) {
  R = qz_gf2_apply(unpad + 32 * (qz_ck_end(len) - len), R);
  return len ? R ^ 0xFFFFFFFFu : 0u;
}

// The row's Adler-32 from the sums over all threads (each reduced mod
// 65521).
__host__ __device__ inline uint32_t qz_adler_finish(uint32_t s1, uint32_t s2,
                                                    int len) {
  const uint32_t pad = (uint32_t)(qz_ck_end(len) - len);
  const uint32_t A = (1u + s1) % QZ_ADLER_MOD;
  const uint32_t B = (s2 + (uint32_t)len % QZ_ADLER_MOD + QZ_ADLER_MOD -
                      pad * s1 % QZ_ADLER_MOD) % QZ_ADLER_MOD;
  return B << 16 | A;
}

// Adler sums added mod 65521.
__host__ __device__ inline uint32_t qz_adler_add(uint32_t a, uint32_t b) {
  return (a + b) % QZ_ADLER_MOD;
}
