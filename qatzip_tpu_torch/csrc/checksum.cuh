// Device CRC32 and Adler-32 of a batch of rows: one thread's share of a
// row, and the combine.
//
// The function of qatzip_tpu/ops/checksums.py:91 (crc32_blocks) and :139
// (adler32_blocks), ported as plain torch in
// qatzip_tpu_torch/ops/checksums.py: the zlib-convention checksum of
// data[b, :len[b]].  A CTA takes a row and each of its threads a
// contiguous slice of it (qz_ck_slice):
//  * CRC32: a slice-by-4 table CRC of the slice with a zero register (8
//    bytes a load where the row is 8-byte aligned), then
//    advanced over the bytes after the slice by the zero-advance matrices
//    ("advance the register by 2^k zero bytes", the ones
//    ops/checksums._host_tables builds); the XOR of the slices' values is
//    the row's raw CRC (CRC is GF(2)-linear), and the init and the final
//    complement follow as in the plain version;
//  * Adler-32: each slice's sums s1 = sum(d) and s2 = sum((e - i) * d_i)
//    (e the slice's end), reduced mod 65521 at most every 5552 bytes as
//    zlib does so that no u32 overflows; the row's B is len + the sum of
//    (len - e) * s1 + s2 over the slices.
//
// __host__ __device__ so that g++ builds the same functions for the CPU
// tests (tests/test_torch_csrc_host.py), which run a CTA's threads one
// after another.  Lengths are clamped to [0, n]; the callers pass lengths
// of at most n.
#pragma once
#include <stdint.h>

#define QZ_CK_THREADS 256      // threads a CTA, a row a CTA
#define QZ_CK_ZADV 25          // zero-advance matrices: 2^0 .. 2^24 bytes
#define QZ_CK_TAB 1024         // slice-by-4 tables: 4 x 256 words
#define QZ_CRC_POLY 0xEDB88320u
#define QZ_ADLER_MOD 65521u
#define QZ_ADLER_NMAX 5552     // zlib's NMAX: bytes between reductions

struct QzCkArgs {
  const uint8_t* data;    // row b at data + b * stride
  int64_t stride;
  const int32_t* len;     // [rows]
  const uint32_t* zadv;   // [QZ_CK_ZADV][32] matrix columns
  int64_t* out;           // [rows] u32 checksums
  int rows, n;
  int kind;               // 0 CRC32, 1 Adler-32
};

// Thread t's slice [a, e) of a row of len bytes: a multiple of 8 bytes
// each, so on a row that starts 8-byte aligned every slice does, and the
// 8-byte loads cover all but the row's last few bytes.
__host__ __device__ inline void qz_ck_slice(int len, int t, int* a, int* e) {
  int s = (len + QZ_CK_THREADS - 1) / QZ_CK_THREADS;
  s = (s + 7) & ~7;
  const int lo = t * s < len ? t * s : len;
  *a = lo;
  *e = lo + s < len ? lo + s : len;
}

// Entry x of table k (k = 0: the CRC of byte x; k > 0: table k - 1's entry
// advanced over one zero byte), from table k - 1 where k > 0.
__host__ __device__ inline uint32_t qz_crc_tab_entry(const uint32_t* tab,
                                                     int k, uint32_t x) {
  if (k == 0) {
    uint32_t c = x;
    for (int i = 0; i < 8; ++i)
      c = (c >> 1) ^ (QZ_CRC_POLY & (0u - (c & 1u)));
    return c;
  }
  const uint32_t p = tab[256 * (k - 1) + x];
  return (p >> 8) ^ tab[p & 0xFFu];
}

// The 8 bytes at p, little-endian: one load on the card, where p is
// 8-byte aligned (a lane's bytes are not next to its neighbours', so a
// load a byte would cost a warp 32 L1 wavefronts a byte).
__host__ __device__ inline uint64_t qz_ck_load8(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *(const uint64_t*)p;
#else
  uint64_t v = 0;
  for (int k = 0; k < 8; ++k) v |= (uint64_t)p[k] << (8 * k);
  return v;
#endif
}

// Whether a row's slices can be read 8 bytes a load.
__host__ __device__ inline bool qz_ck_wide(const uint8_t* row) {
  return ((uintptr_t)row & 7u) == 0;
}

// The register c after the 4 bytes of w (slice-by-4).
__host__ __device__ inline uint32_t qz_crc_word(const uint32_t* tab,
                                                uint32_t c, uint32_t w) {
  c ^= w;
  return tab[768 + (c & 0xFFu)] ^ tab[512 + ((c >> 8) & 0xFFu)] ^
         tab[256 + ((c >> 16) & 0xFFu)] ^ tab[c >> 24];
}

// The raw CRC (register starting at 0, no complement) of p[0, len), 8
// bytes a load where wide.
__host__ __device__ inline uint32_t qz_crc_raw(const uint32_t* tab,
                                               const uint8_t* p, int len,
                                               bool wide) {
  uint32_t c = 0;
  int i = 0;
  if (wide) {
    for (; i + 8 <= len; i += 8) {
      const uint64_t v = qz_ck_load8(p + i);
      c = qz_crc_word(tab, c, (uint32_t)v);
      c = qz_crc_word(tab, c, (uint32_t)(v >> 32));
    }
  }
  for (; i < len; ++i) c = (c >> 8) ^ tab[(c ^ p[i]) & 0xFFu];
  return c;
}

// A GF(2) 32x32 matrix (its columns) applied to v.
__host__ __device__ inline uint32_t qz_gf2_apply(const uint32_t* cols,
                                                 uint32_t v) {
  uint32_t acc = 0;
  for (int b = 0; b < 32; ++b) acc ^= cols[b] & (0u - ((v >> b) & 1u));
  return acc;
}

// The register c advanced over m < 2^QZ_CK_ZADV zero bytes.
__host__ __device__ inline uint32_t qz_crc_advance(const uint32_t* zadv,
                                                   uint32_t c, uint32_t m) {
  for (int k = 0; k < QZ_CK_ZADV; ++k)
    if ((m >> k) & 1u) c = qz_gf2_apply(zadv + 32 * k, c);
  return c;
}

// Thread t's share of a row's raw CRC: its slice's, advanced over the
// bytes after the slice.
__host__ __device__ inline uint32_t qz_crc_part(const uint32_t* tab,
                                                const uint32_t* zadv,
                                                const uint8_t* row, int len,
                                                int t) {
  int a, e;
  qz_ck_slice(len, t, &a, &e);
  return qz_crc_advance(zadv, qz_crc_raw(tab, row + a, e - a,
                                         qz_ck_wide(row)),
                        (uint32_t)(len - e));
}

// zlib's CRC32 from the XOR of the parts: the init 0xFFFFFFFF advanced over
// the row's bytes joins by linearity, then the final complement.
__host__ __device__ inline uint32_t qz_crc_finish(const uint32_t* zadv,
                                                  uint32_t raw, int len) {
  return raw ^ qz_crc_advance(zadv, 0xFFFFFFFFu, (uint32_t)len) ^
         0xFFFFFFFFu;
}

// Thread t's share of a row's Adler sums: s1 of its slice, and s2 of its
// slice weighted as the row's B weighs it (each byte by the bytes from it
// to the row's end), both mod 65521.
__host__ __device__ inline void qz_adler_part(const uint8_t* row, int len,
                                              int t, uint32_t* s1o,
                                              uint32_t* s2o) {
  int a, e;
  qz_ck_slice(len, t, &a, &e);
  const bool wide = qz_ck_wide(row);
  uint32_t s1 = 0, s2 = 0;
  for (int i = a; i < e;) {
    // NMAX rounded down to whole loads of 8
    const int stop = e - i > QZ_ADLER_NMAX ? i + (QZ_ADLER_NMAX & ~7) : e;
    if (wide) {
      for (; i + 8 <= stop; i += 8) {
        const uint64_t v = qz_ck_load8(row + i);
        for (int k = 0; k < 8; ++k) {
          s1 += (uint32_t)(v >> (8 * k)) & 0xFFu;
          s2 += s1;
        }
      }
    }
    for (; i < stop; ++i) {
      s1 += row[i];
      s2 += s1;
    }
    s1 %= QZ_ADLER_MOD;
    s2 %= QZ_ADLER_MOD;
  }
  *s1o = s1;
  *s2o = (uint32_t)(((uint64_t)((uint32_t)(len - e) % QZ_ADLER_MOD) * s1 +
                     s2) % QZ_ADLER_MOD);
}

// zlib's Adler-32 from the sums of the parts (each sum of QZ_CK_THREADS
// values below 65521).
__host__ __device__ inline uint32_t qz_adler_finish(uint32_t s1, uint32_t s2,
                                                    int len) {
  const uint32_t A = (1u + s1 % QZ_ADLER_MOD) % QZ_ADLER_MOD;
  const uint32_t B =
      ((uint32_t)len % QZ_ADLER_MOD + s2 % QZ_ADLER_MOD) % QZ_ADLER_MOD;
  return B << 16 | A;
}

__host__ __device__ inline int qz_ck_len(const QzCkArgs& a, int row) {
  const int len = a.len[row];
  return len < 0 ? 0 : len > a.n ? a.n : len;
}
