// The LZ4 / LZ4s block decoder: one block's work, a warp of 32 lanes.
//
// The semantics of qatzip_tpu_torch/ops/lz4_decode.py:_decode_blocks_impl
// (the port of qatzip_tpu/ops/lz4_decode.py:42) for ONE row, walked in
// sequence order instead of parsed at every byte.  A row is a block of
// len bytes in a zero-padded row of n; it decodes to at most outcap bytes:
//  * a sequence is token, [literal-length extension], literals, and unless
//    the literals end exactly at len, a 2-byte offset and [match-length
//    extension]; LZ4 adds 4 to the match length, LZ4s adds base unless it
//    is 0;
//  * a length extension whose run of 0xFF bytes reaches QZ_LZ4_EXT_RUN_CAP
//    is an error (the plain version's doubling stops there), as is a field
//    that reaches past len, a non-terminal offset of 0 (LZ4s too), a match
//    of length > 0 that reaches before the output's start, and more than
//    outcap bytes of output;
//  * the row's err is set on the first error; tot and the output are the
//    plain version's only where err is clear.
//
// Layout on the card (csrc/lz4_block.cu): one warp a block, a CTA a warp.
// Every lane parses each sequence header itself (the same bytes, one
// broadcast load each); a length extension takes 32 bytes a step, a lane a
// byte, and a ballot finds the first byte that is not 0xFF.  The warp then
// copies the literals from the input row and the match from the row's own
// output, 32 bytes a step.  A match copies byte after byte in meaning, so
// its source repeats with period off: byte i takes byte (i mod off) - off
// of the output before it, which is written before the match starts, so no
// byte of a match waits for another (no rounds for off < 32).  One
// __syncwarp a sequence, before its match, makes the literals and earlier
// matches visible.  Nothing is read at or past len, and nothing written
// at or past outcap.
//
// The warp is a template parameter W (each, sync, ballot): lz4_block.cu
// gives the lane's own view, and the host tests
// (tests/test_torch_csrc_host.py) one that runs the 32 lanes in turn.
// __host__ __device__ so that g++ builds the same code for them.
#pragma once
#include <stdint.h>

#define QZ_LZ4_LANES 32
#define QZ_LZ4_EXT_RUN_CAP 512   // a 0xFF run this long is an error

#ifdef __CUDA_ARCH__
#define QZ_LZ4_LDG(p) __ldg(p)
#define QZ_LZ4_CTZ(x) (__ffs(x) - 1)
#else
#define QZ_LZ4_LDG(p) (*(p))
#define QZ_LZ4_CTZ(x) __builtin_ctz(x)
#endif

// One launch's arguments; rows of n input bytes and outcap output bytes.
struct QzLz4Args {
  const uint8_t* in;     // [rows, n], the block then zero padding
  const int32_t* len;    // [rows], the block's bytes, 0 <= len <= n
  int rows;
  int n;
  int outcap;
  int lz4s;              // LZ4s (0: LZ4)
  int base;              // LZ4s: added to a match length that is not 0
  uint8_t* out;          // [rows, outcap], zero-filled by the caller
  int32_t* tot;          // [rows], bytes decoded
  uint8_t* err;          // [rows], 1 for a row in error
};

// One sequence, as every lane sees it.
struct QzLz4Seq {
  int32_t lit;      // first literal byte in the row
  int32_t litlen;
  int32_t off;      // 0 for the terminal, literal-only sequence
  int32_t mlen;
  int32_t next;     // the next token's position; len after the terminal
};

// The length extension at q: its value (255 x the run of 0xFF bytes, plus
// the byte that ends the run) into *value; returns its bytes, or -1 when
// the run reaches QZ_LZ4_EXT_RUN_CAP or the extension does not end before
// len.  A step of the warp reads 32 bytes, lane l byte q + run + l.
template <class W>
__host__ __device__ inline int qz_lz4_ext(const uint8_t* row, int len, int q,
                                          W& w, int32_t* value) {
  int run = 0;
  for (;;) {
    const int at = q + run;
    const uint32_t stop = w.ballot([&](int lane) {
      const int i = at + lane;
      return i >= len || QZ_LZ4_LDG(row + i) != 0xFF;
    });
    if (stop) {
      run += QZ_LZ4_CTZ(stop);
      break;
    }
    run += QZ_LZ4_LANES;
    if (run >= QZ_LZ4_EXT_RUN_CAP) return -1;
  }
  if (run >= QZ_LZ4_EXT_RUN_CAP || q + run >= len) return -1;
  *value = 255 * run + QZ_LZ4_LDG(row + q + run);
  return run + 1;
}

// The sequence whose token is at p (p < len) into *s; false for a sequence
// in error.
template <class W>
__host__ __device__ inline bool qz_lz4_parse(const uint8_t* row, int len,
                                             int p, int lz4s, int base, W& w,
                                             QzLz4Seq* s) {
  const int tok = QZ_LZ4_LDG(row + p);
  int q = p + 1;
  int32_t litlen = tok >> 4;
  if (litlen == 15) {
    int32_t v;
    const int k = qz_lz4_ext(row, len, q, w, &v);
    if (k < 0) return false;
    litlen += v;
    q += k;
  }
  s->lit = q;
  s->litlen = litlen;
  const int q2 = q + litlen;   // the offset field
  if (q2 > len) return false;
  if (q2 == len) {             // the terminal sequence: literals only
    s->off = 0;
    s->mlen = 0;
    s->next = len;
    return true;
  }
  if (q2 + 2 > len) return false;
  s->off = QZ_LZ4_LDG(row + q2) | (QZ_LZ4_LDG(row + q2 + 1) << 8);
  if (s->off == 0) return false;
  q = q2 + 2;
  int32_t m = tok & 15;
  if (m == 15) {
    int32_t v;
    const int k = qz_lz4_ext(row, len, q, w, &v);
    if (k < 0) return false;
    m += v;
    q += k;
  }
  s->mlen = lz4s ? (m ? m + base : 0) : m + 4;
  s->next = q;
  return true;
}

// Lane `lane`'s bytes of a literal run: dst[i] = src[i] for i = lane,
// lane + 32, ... below len.
__host__ __device__ inline void qz_lz4_copy_literals(uint8_t* dst,
                                                     const uint8_t* src,
                                                     int len, int lane) {
  for (int i = lane; i < len; i += QZ_LZ4_LANES) dst[i] = QZ_LZ4_LDG(src + i);
}

// Lane `lane`'s bytes of a match of len bytes at dst, off bytes back:
// dst[i] = dst[i - off] in order, that is dst[(i mod off) - off], read from
// the output before dst.  r runs i mod off without a division a byte.
__host__ __device__ inline void qz_lz4_copy_match(uint8_t* dst, int off,
                                                  int len, int lane) {
  const int step = QZ_LZ4_LANES % off;
  int r = lane % off;
  for (int i = lane; i < len; i += QZ_LZ4_LANES) {
    dst[i] = dst[r - off];
    r += step;
    if (r >= off) r -= off;
  }
}

// Row r of a launch, decoded by warp w.
template <class W>
__host__ __device__ inline void qz_lz4_row(const QzLz4Args& a, int r, W& w) {
  const uint8_t* row = a.in + (int64_t)r * a.n;
  uint8_t* out = a.out + (int64_t)r * a.outcap;
  const int len = a.len[r];
  bool bad = len < 0 || len > a.n;
  int o = 0;
  int p = 0;
  while (!bad && p < len) {
    QzLz4Seq s;
    if (!qz_lz4_parse(row, len, p, a.lz4s, a.base, w, &s) ||
        s.litlen > a.outcap - o) {
      bad = true;
      break;
    }
    w.each([&](int lane) {
      qz_lz4_copy_literals(out + o, row + s.lit, s.litlen, lane);
    });
    o += s.litlen;
    if (s.mlen > 0) {
      if (s.off > o || s.mlen > a.outcap - o) {
        bad = true;
        break;
      }
      w.sync();
      w.each([&](int lane) {
        qz_lz4_copy_match(out + o, s.off, s.mlen, lane);
      });
      o += s.mlen;
    }
    p = s.next;
  }
  w.each([&](int lane) {
    if (lane == 0) {
      a.tot[r] = o;
      a.err[r] = bad;
    }
  });
}
