// The LZ4 / LZ4s block decoder: one block's work, a CTA of two warps.
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
//    plain version's only where err is clear.  Output bytes at and past
//    tot, and every output byte of a row in error, are unspecified: the
//    caller allocates out without filling it and reads [0, tot).
// Nothing is read at or past len, and nothing written at or past outcap.
//
// Layout (csrc/lz4_block.cu): a CTA a block, two warps, in rounds between
// CTA barriers.  The chain of sequence headers depends only on the input,
// so it is taken off the copies:
//  * the parse warp queues up to QZ_LZ4_K sequence records a round (input
//    position of the literals, their length, offset, match length) in one
//    of two slots, a round's input at most about QZ_LZ4_SPAN bytes.  It
//    parses 32 bytes of input at once: every lane parses the common header
//    (length extensions of one byte, all of it staged) at its own byte, the
//    chain from the first byte is walked by shuffles, one a sequence, and
//    the chain's lanes check and queue their sequences together.  Any other
//    header (a longer extension, the block's last, one not staged) takes
//    the general parse: every lane the same bytes, a length extension 32
//    bytes a step, a ballot finds the first byte that is not 0xFF.  An
//    error that moves no field (an offset of 0, an offset before the
//    output's start, output past outcap) is noted and the round ends with
//    the row in error;
//  * the copy warp copies the round before's records into the match
//    window and to the row's output in device memory (a byte a lane, the
//    warp's 32 stores one coalesced sector): a step takes up to
//    QZ_LZ4_GROUP sequences whose output fits in 32 bytes and whose matches
//    read only bytes before the step, each lane choosing its byte's
//    sequence, literal or match by compares and selects; any other sequence
//    copies its literals 32 bytes a step, then its match as below;
//  * the input reaches shared memory by cp.async into a ring of QZ_LZ4_NSEG
//    segments of QZ_LZ4_SEG bytes, refilled a round ahead of the parse (the
//    copy warp issues a round's refills and waits for them at the round's
//    end, so a refill has a round to land); a byte outside the landed
//    segments (the tail of a literal run longer than the ring, a header
//    after it) is read from device memory instead;
//  * the match window is a ring of the newest QZ_LZ4_WIN = 64 KB of output:
//    an offset is at most 65535, so every match source is in it.
// A match copies byte after byte in meaning.  A step of w <= 32 bytes at
// match byte b reads, for lane l, the byte at b - off + (l mod off): it is
// congruent to b + l mod off, so it holds the same value, and it lies
// before b, so an earlier step wrote it (a __syncwarp before every step).
// With w <= 65536 - off no byte a step writes lands on a window slot the
// step reads, so a match longer than the window wraps it safely.
//
// The hot loops have no branch but their exits, and their stores are
// predicated: a branch that can split the warp costs a reconvergence
// barrier on this card.  Loads run ahead of their use (the copy warp's
// next records; the parse's speculative loads, any ring slot being in
// bounds).  Shared memory is reached through 32-bit shared addresses
// (QzLz4Shm): through a generic pointer sm_90 reads the CTA's cluster rank
// (an S2R) before every load.
//
// The warps are template parameters (each, sync, ballot, shfl, a per-lane
// register, the refill's copy, and two hooks that see every byte read from
// the staged input and from the window), and the CTA's roles and barrier
// are one too: lz4_block.cu gives a lane's own view, and the host tests
// (tests/test_torch_csrc_host.py) one thread that runs both warps' rounds
// in turn with the 32 lanes of each in turn, and checks every staged byte
// against the block and every window byte against the output.
// __host__ __device__ so that g++ builds the same code for them.
#pragma once
#include <stdint.h>

#define QZ_LZ4_LANES 32
#define QZ_LZ4_EXT_RUN_CAP 512   // a 0xFF run this long is an error
#define QZ_LZ4_WIN (1 << 16)     // the match window; every offset reaches it
#define QZ_LZ4_SEG 1024          // an input refill, whole segments
#define QZ_LZ4_NSEG 4            // segments in the input ring
#define QZ_LZ4_RING (QZ_LZ4_SEG * QZ_LZ4_NSEG)
#define QZ_LZ4_K 64              // sequences a round (a queue slot)
#define QZ_LZ4_SPAN (QZ_LZ4_RING / 4)   // input bytes a round, about
#define QZ_LZ4_GROUP 4           // sequences a copy step may take
#define QZ_LZ4_CHUNK 16          // bytes a cp.async
// byte offsets in a CTA's shared memory (QzLz4Smem)
#define QZ_LZ4_AT_RING QZ_LZ4_WIN
#define QZ_LZ4_AT_Q (QZ_LZ4_AT_RING + QZ_LZ4_RING)
#define QZ_LZ4_AT_HEAD (QZ_LZ4_AT_Q + 2 * QZ_LZ4_K * 16)

#ifdef __CUDACC__
#define QZ_LZ4_COLD __noinline__   // a slow path, kept out of the loop
#else
#define QZ_LZ4_COLD __attribute__((noinline))
#endif

#ifdef __CUDA_ARCH__
#define QZ_LZ4_LDG(p) __ldg(p)
#define QZ_LZ4_CTZ(x) (__ffs(x) - 1)
#define QZ_LZ4_POPC(x) __popc(x)
#else
#define QZ_LZ4_LDG(p) (*(p))
#define QZ_LZ4_CTZ(x) __builtin_ctz(x)
#define QZ_LZ4_POPC(x) __builtin_popcount(x)
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
  uint8_t* out;          // [rows, outcap], bytes past tot unspecified
  int32_t* tot;          // [rows], bytes decoded
  uint8_t* err;          // [rows], 1 for a row in error
};

// One sequence, as the parse warp sees it.
struct QzLz4Seq {
  int32_t lit;      // first literal byte in the row
  int32_t litlen;
  int32_t off;      // 0 for the terminal, literal-only sequence
  int32_t mlen;
  int32_t next;     // the next token's position; len after the terminal
  int32_t zero;     // a sequence with an offset field of 0 (an error)
};

// A queued sequence: what the copy warp needs of it.
struct QzLz4Rec {
  int32_t lit, litlen, off, mlen;
};

// A round's parse: its input span [start, end) (end: the next token), its
// records, the output after them, and whether it is the block's last.
struct QzLz4Head {
  int32_t start, end, count, o, final, bad, pad0, pad1;
};

// A CTA's shared memory.
struct QzLz4Smem {
  uint8_t win[QZ_LZ4_WIN];
  alignas(16) uint8_t ring[QZ_LZ4_RING];
  QzLz4Rec q[2][QZ_LZ4_K];
  QzLz4Head head[2];
};
static_assert(sizeof(QzLz4Smem) == QZ_LZ4_AT_HEAD + 2 * sizeof(QzLz4Head),
              "QzLz4Smem's layout is not the QZ_LZ4_AT_* offsets'");

// Four int32 moved as one 16-byte shared-memory access.
struct QzLz4I4 {
  int32_t x, y, z, w;
};

// A CTA's QzLz4Smem by byte offset: on the card a shared-memory address
// reached by ld.shared / st.shared, here a pointer.
struct QzLz4Shm {
  uint64_t at;

  __host__ __device__ uint8_t* host(int off) const {
    return (uint8_t*)(uintptr_t)at + off;
  }
  __host__ __device__ int ld8(int off) const {
#ifdef __CUDA_ARCH__
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"((uint32_t)at + off)
                 : "memory");
    return (int)v;
#else
    return *host(off);
#endif
  }
  __host__ __device__ void st8(int off, int v) const {
#ifdef __CUDA_ARCH__
    asm volatile("st.shared.u8 [%0], %1;" ::"r"((uint32_t)at + off), "r"(v)
                 : "memory");
#else
    *host(off) = (uint8_t)v;
#endif
  }
  // st8 where p holds, by a predicated store (no branch)
  __host__ __device__ void st8_if(int off, int v, bool p) const {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
        " @q st.shared.u8 [%0], %1;\n}" ::"r"((uint32_t)at + off),
        "r"(v), "r"((uint32_t)p)
        : "memory");
#else
    if (p) *host(off) = (uint8_t)v;
#endif
  }
  // st16 where p holds, by a predicated store (no branch)
  __host__ __device__ void st16_if(int off, QzLz4I4 v, bool p) const {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.u32 q, %5, 0;\n"
        " @q st.shared.v4.s32 [%0], {%1, %2, %3, %4};\n}" ::"r"(
            (uint32_t)at + off),
        "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((uint32_t)p)
        : "memory");
#else
    if (p) __builtin_memcpy(host(off), &v, sizeof v);
#endif
  }
  __host__ __device__ QzLz4I4 ld16(int off) const {
    QzLz4I4 v;
#ifdef __CUDA_ARCH__
    asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"((uint32_t)at + off)
                 : "memory");
#else
    __builtin_memcpy(&v, host(off), sizeof v);
#endif
    return v;
  }
  __host__ __device__ void st16(int off, QzLz4I4 v) const {
#ifdef __CUDA_ARCH__
    asm volatile("st.shared.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(
                     (uint32_t)at + off),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
#else
    __builtin_memcpy(host(off), &v, sizeof v);
#endif
  }
};

// *q = v where p holds, by a predicated store (no branch)
__host__ __device__ inline void qz_lz4_stg_if(uint8_t* q, int v, bool p) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n .reg .pred r;\n setp.ne.u32 r, %2, 0;\n"
      " @r st.global.u8 [%0], %1;\n}" ::"l"(q),
      "r"(v), "r"((uint32_t)p)
      : "memory");
#else
  if (p) *q = (uint8_t)v;
#endif
}

__host__ __device__ inline int qz_lz4_q_at(int slot, int k) {
  return QZ_LZ4_AT_Q + (slot * QZ_LZ4_K + k) * 16;
}

__host__ __device__ inline QzLz4Rec qz_lz4_ldrec(const QzLz4Shm& sm,
                                                 int slot, int k) {
  const QzLz4I4 v = sm.ld16(qz_lz4_q_at(slot, k));
  return QzLz4Rec{v.x, v.y, v.z, v.w};
}

__host__ __device__ inline QzLz4Head qz_lz4_ldhead(const QzLz4Shm& sm,
                                                   int slot) {
  const int at = QZ_LZ4_AT_HEAD + slot * (int)sizeof(QzLz4Head);
  const QzLz4I4 a = sm.ld16(at), b = sm.ld16(at + 16);
  return QzLz4Head{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// The staged input of a round: bytes [lo, hi) of the row are in the ring
// (at their position mod QZ_LZ4_RING), the rest is read from the row.
struct QzLz4In {
  const uint8_t* row;
  QzLz4Shm sm;
  int len;
  int lo, hi;

  __host__ __device__ bool holds(int i, int k) const {
    return i >= lo && i + k <= hi;
  }
};

// Byte i < len of the block, from the ring where it is staged (on the card
// one predicated load either way, no branch).
template <class W>
__host__ __device__ inline int qz_lz4_get(const QzLz4In& in, int i, W& w) {
  const bool staged = in.holds(i, 1);
  const int ring = QZ_LZ4_AT_RING + (i & (QZ_LZ4_RING - 1));
#ifdef __CUDA_ARCH__
  uint32_t v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %3, 0;\n"
      " @p ld.shared.u8 %0, [%1];\n @!p ld.global.nc.u8 %0, [%2];\n}"
      : "=r"(v)
      : "r"((uint32_t)in.sm.at + ring), "l"(in.row + i),
        "r"((uint32_t)staged)
      : "memory");
#else
  const int v = staged ? in.sm.ld8(ring) : in.row[i];
#endif
  w.seen_input(i, (int)v, staged);
  return (int)v;
}

// The ring's byte for position i, staged or not (any slot is in bounds):
// a speculative load, checked before its value is used.
__host__ __device__ inline int qz_lz4_peek(const QzLz4In& in, int i) {
  return in.sm.ld8(QZ_LZ4_AT_RING + (i & (QZ_LZ4_RING - 1)));
}

// The bytes the window parse read for the common header at c, fed to the
// hooks (host checks only).
template <class W>
__host__ __device__ inline void qz_lz4_seen_header(const QzLz4In& in, int c,
                                                   W& w) {
  const int t = qz_lz4_peek(in, c), l15 = (t >> 4) == 15;
  w.seen_input(c, t, true);
  if (l15) w.seen_input(c + 1, qz_lz4_peek(in, c + 1), true);
  const int q2 = c + 1 + l15 + (l15 ? 15 + qz_lz4_peek(in, c + 1) : t >> 4);
  w.seen_input(q2, qz_lz4_peek(in, q2), true);
  w.seen_input(q2 + 1, qz_lz4_peek(in, q2 + 1), true);
  if ((t & 15) == 15) w.seen_input(q2 + 2, qz_lz4_peek(in, q2 + 2), true);
}

// Byte i of the block where the caller knows the ring holds it.
template <class W>
__host__ __device__ inline int qz_lz4_ring(const QzLz4In& in, int i, W& w) {
  const int v = in.sm.ld8(QZ_LZ4_AT_RING + (i & (QZ_LZ4_RING - 1)));
  w.seen_input(i, v, true);
  return v;
}

// The segments of the input ring: [q0, q1) requested (landed once the copy
// warp has waited at a round's end), [v0, v1) landed and kept for the
// round to come.
struct QzLz4Stage {
  int q0, q1, v0, v1;
};

// The ring for the round after a parse of [start, end): anchored at the
// segment of the copy warp's next literals, or further on where that
// leaves the parse less than half the ring ahead.  The segments both ranges
// share stay (their slots are untouched), the rest are refilled; a slot of
// a segment that leaves is the slot of one that comes.
__host__ __device__ inline void qz_lz4_stage_plan(QzLz4Stage& s, int start,
                                                  int end, int len) {
  const int nseg = (len + QZ_LZ4_SEG - 1) / QZ_LZ4_SEG;
  int a = end - QZ_LZ4_RING / 2;
  a = (a > start ? a : start) / QZ_LZ4_SEG;
  const int b = a + QZ_LZ4_NSEG < nseg ? a + QZ_LZ4_NSEG : nseg;
  s.v0 = s.q0 > a ? s.q0 : a;
  s.v1 = s.q1 < b ? s.q1 : b;
  if (s.v1 < s.v0) s.v1 = s.v0;
  s.q0 = a;
  s.q1 = b > a ? b : a;
}

// The input staged for a round of stage s.
__host__ __device__ inline QzLz4In qz_lz4_input(const uint8_t* row,
                                                const QzLz4Shm& sm, int len,
                                                const QzLz4Stage& s) {
  const int hi = s.v1 * QZ_LZ4_SEG;
  return QzLz4In{row, sm, len, s.v0 * QZ_LZ4_SEG, hi < len ? hi : len};
}

// The copy warp's refills for stage s: every segment of [q0, q1) outside
// [v0, v1), QZ_LZ4_CHUNK bytes a lane a step, none at or past len.
template <class W>
__host__ __device__ inline void qz_lz4_stage_issue(const uint8_t* row,
                                                   const QzLz4Shm& sm,
                                                   int len,
                                                   const QzLz4Stage& s,
                                                   W& w) {
  for (int g = s.q0; g < s.q1; ++g) {
    if (g >= s.v0 && g < s.v1) continue;
    w.each([&](int lane) {
      for (int c = lane; c < QZ_LZ4_SEG / QZ_LZ4_CHUNK; c += QZ_LZ4_LANES) {
        const int at = g * QZ_LZ4_SEG + c * QZ_LZ4_CHUNK;
        if (at < len)
          w.stage(sm, QZ_LZ4_AT_RING + (at & (QZ_LZ4_RING - 1)), row + at,
                  len - at < QZ_LZ4_CHUNK ? len - at : QZ_LZ4_CHUNK);
      }
    });
  }
  w.commit();
}

// The length extension at q: its value (255 x the run of 0xFF bytes, plus
// the byte that ends the run) into *value; returns its bytes, or -1 when
// the run reaches QZ_LZ4_EXT_RUN_CAP or the extension does not end before
// len.  A step of the warp reads 32 bytes, lane l byte q + run + l.
template <class W>
__host__ __device__ inline int qz_lz4_ext(const QzLz4In& in, int q, W& w,
                                          int32_t* value) {
  const int len = in.len;
  int run = 0;
  for (;;) {
    const int at = q + run;
    const uint32_t stop = w.ballot([&](int lane) {
      const int i = at + lane;
      return i >= len || qz_lz4_get(in, i, w) != 0xFF;
    });
    if (stop) {
      run += QZ_LZ4_CTZ(stop);
      break;
    }
    run += QZ_LZ4_LANES;
    if (run >= QZ_LZ4_EXT_RUN_CAP) return -1;
  }
  if (run >= QZ_LZ4_EXT_RUN_CAP || q + run >= len) return -1;
  *value = 255 * run + qz_lz4_get(in, q + run, w);
  return run + 1;
}

// The sequence whose token, tok, is at p (p < len) into *s; false for a
// field that reaches past len or a length extension at the cap, the
// errors that move the next token.  The next token's position depends on
// the token and the extensions only, never on the offset's bytes: an
// offset of 0 is only noted (s->zero).
template <class W>
__host__ __device__ QZ_LZ4_COLD bool qz_lz4_parse(const QzLz4In& in, int p,
                                             int tok, int lz4s, int base,
                                             W& w, QzLz4Seq* s) {
  const int len = in.len;
  int q = p + 1;
  int32_t litlen = tok >> 4;
  if (litlen == 15) {
    int32_t v;
    const int k = qz_lz4_ext(in, q, w, &v);
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
    s->zero = 0;
    return true;
  }
  if (q2 + 2 > len) return false;
  s->off = qz_lz4_get(in, q2, w) | (qz_lz4_get(in, q2 + 1, w) << 8);
  s->zero = s->off == 0;
  q = q2 + 2;
  int32_t m = tok & 15;
  if (m == 15) {
    int32_t v;
    const int k = qz_lz4_ext(in, q, w, &v);
    if (k < 0) return false;
    m += v;
    q += k;
  }
  s->mlen = lz4s ? (m ? m + base : 0) : m + 4;
  s->next = q;
  return true;
}

// The parse warp's round: from *p, with *o bytes of output before it, up
// to QZ_LZ4_K sequences into slot `slot` of the queue and its head, 32
// bytes of input at a time (the head of this file).  A sequence in error
// ends the walk where it moves the next token, else the round's end; the
// head then marks the row in error.
template <class W>
__host__ __device__ inline void qz_lz4_produce(const QzLz4In& in,
                                               const QzLz4Args& a, int slot,
                                               int* p, int* o, W& w) {
  const int start = *p;
  int count = 0;
  bool bad = false;
  // a sequence's errors that move no field, bitwise (no branch), for a
  // sequence of lit literals and an mlen-byte match at offset off after o0
  // bytes of output
  auto errs = [&](int lit, int off, int mlen, int zero, int o0) -> bool {
    const int o2 = o0 + lit;
    return zero | (lit > a.outcap - o0) |
           ((mlen > 0) & ((off > o2) | (mlen > a.outcap - o2)));
  };
  // a window: lane l's speculative parse of a sequence at p0 + l
  typename W::template Reg<int> step, litpos, litlen, off, mlen, at_o, errl;
  w.each([&](int lane) { errl[lane] = 0; });
  // A round ends after QZ_LZ4_K sequences or QZ_LZ4_SPAN bytes of input:
  // the ring holds the copy warp's round, the parse warp's and the refill
  // a round ahead.
  while (count < QZ_LZ4_K && *p < in.len && *p - start < QZ_LZ4_SPAN) {
    const int p0 = *p;
    // Every lane parses the common header (length extensions of one byte
    // each, all of it staged, so not the block's last) at its own byte of
    // the window from ring loads (any slot is in bounds), and gives its
    // output bytes and the next token's position relative to p0 in one word
    // (0xFFFF for any other header).
    w.each([&](int lane) {
      const int c = p0 + lane;
      const int t = qz_lz4_peek(in, c), e = qz_lz4_peek(in, c + 1);
      const int lit = t >> 4, m = t & 15, l15 = lit == 15;
      const int ll = l15 ? 15 + e : lit;
      const int q2 = c + 1 + l15 + ll;
      const int of = qz_lz4_peek(in, q2) | (qz_lz4_peek(in, q2 + 1) << 8);
      const int em = qz_lz4_peek(in, q2 + 2);
      const int mraw = m + (m == 15 ? em : 0);
      const bool common = in.holds(c, 2) & !(l15 & (e == 255)) &
                          in.holds(q2, 3) & !((m == 15) & (em == 255));
      litpos[lane] = c + 1 + l15;
      litlen[lane] = ll;
      off[lane] = of;
      mlen[lane] = a.lz4s ? (mraw ? mraw + a.base : 0) : mraw + 4;
      step[lane] = ((ll + mlen[lane]) << 16) |
                   (common ? q2 + 2 + (m == 15) - p0 : 0xFFFF);
    });
    // the chain from lane 0, a shuffle a sequence, each sequence's output
    // start noted in its lane
    int j = 0, n = 0, oacc = *o;
    uint32_t mask = 0;
    bool slow = false;
    for (;;) {
      const int v = w.shfl(step, j);
      const int r = v & 0xFFFF;
      if ((r == 0xFFFF) | (r >= QZ_LZ4_LANES) | (count + n + 1 >= QZ_LZ4_K)) {
        slow = r == 0xFFFF;
        if (!slow) {
          w.set(at_o, j, oacc);
          oacc += v >> 16;
          mask |= 1u << j;
          ++n;
        }
        *p = p0 + (slow ? j : r);
        break;
      }
      w.set(at_o, j, oacc);
      oacc += v >> 16;
      mask |= 1u << j;
      ++n;
      j = r;
    }
    // the chain's sequences checked and queued, a lane each (under a
    // predicate: no branch)
    w.each([&](int lane) {
      const bool on = (mask >> lane) & 1u;
      const int rank = QZ_LZ4_POPC(mask & ((1u << lane) - 1u));
      in.sm.st16_if(qz_lz4_q_at(slot, count + rank),
                    QzLz4I4{litpos[lane], litlen[lane], off[lane],
                            mlen[lane]},
                    on);
      if (W::kCheck && on) qz_lz4_seen_header(in, p0 + lane, w);
      // (at_o is set only on the chain's lanes)
      const int o0 = on ? at_o[lane] : 0;
      errl[lane] |= on & errs(litlen[lane], off[lane], mlen[lane],
                              off[lane] == 0, o0);
    });
    count += n;
    *o = oacc;
    if (!slow) continue;
    if (count >= QZ_LZ4_K || *p >= in.len) break;
    // any other header, by the general parse out of line
    const int tok = qz_lz4_get(in, *p, w);
    QzLz4Seq s;
    if (!qz_lz4_parse(in, *p, tok, a.lz4s, a.base, w, &s)) {
      bad = true;
      break;
    }
    bad |= errs(s.litlen, s.off, s.mlen, s.zero, *o);
    in.sm.st16(qz_lz4_q_at(slot, count),
               QzLz4I4{s.lit, s.litlen, s.off, s.mlen});
    ++count;
    *o += s.litlen + s.mlen;
    *p = s.next;
  }
  bad |= w.ballot([&](int lane) { return errl[lane] != 0; }) != 0;
  const int at = QZ_LZ4_AT_HEAD + slot * (int)sizeof(QzLz4Head);
  in.sm.st16(at, QzLz4I4{start, *p, count, *o});
  in.sm.st16(at + 16, QzLz4I4{bad || *p >= in.len, bad, 0, 0});
}

// n literal bytes from input position src to output position o: into the
// window and the row's output.  A run the ring holds is read from it, any
// other from device memory, in a loop unrolled 8 times so that a lane has
// 8 loads in flight.
template <class W>
__host__ __device__ inline void qz_lz4_copy_literals(const QzLz4In& in,
                                                     int src, int n,
                                                     uint8_t* out, int o,
                                                     W& w) {
  const QzLz4Shm& sm = in.sm;
  if (in.holds(src, n)) {
    w.each([&](int lane) {
      for (int i = lane; i < n; i += QZ_LZ4_LANES) {
        const int v = qz_lz4_ring(in, src + i, w);
        sm.st8((o + i) & (QZ_LZ4_WIN - 1), v);
        out[o + i] = (uint8_t)v;
      }
    });
    return;
  }
  w.each([&](int lane) {
#ifdef __CUDACC__
#pragma unroll 8
#endif
    for (int i = lane; i < n; i += QZ_LZ4_LANES) {
      const uint8_t v = QZ_LZ4_LDG(in.row + src + i);
      w.seen_input(src + i, v, false);
      sm.st8((o + i) & (QZ_LZ4_WIN - 1), v);
      out[o + i] = v;
    }
  });
}

// A match of n bytes at output position o, off bytes back, from the window
// into the window and the row's output, a step of width bytes at a time
// (the head of this file says why this order is the byte-by-byte copy's).
// A __syncwarp before each step's reads makes the bytes the warp wrote
// before visible; the writes after the match land past the bytes it read.
template <class W>
__host__ __device__ inline void qz_lz4_copy_match(const QzLz4Shm& sm,
                                                  uint8_t* out, int o,
                                                  int off, int n, W& w) {
  const int width = QZ_LZ4_WIN - off < QZ_LZ4_LANES ? QZ_LZ4_WIN - off
                                                    : QZ_LZ4_LANES;
  for (int b = 0; b < n; b += width) {
    w.sync();
    w.each([&](int lane) {
      if (lane < width && b + lane < n) {
        const int from = o + b - off + lane % off;
        const int v = sm.ld8(from & (QZ_LZ4_WIN - 1));
        w.seen_window(from, v);
        sm.st8((o + b + lane) & (QZ_LZ4_WIN - 1), v);
        out[o + b + lane] = (uint8_t)v;
      }
    });
  }
}

// The copy warp's round: the count records of slot `slot`, the first at
// output position *o.  A step of the warp copies a group of up to
// QZ_LZ4_GROUP consecutive sequences at once when their output fits in
// QZ_LZ4_LANES bytes, their literals are staged and each match's source
// lies wholly before the step: lane l takes output byte o + l, from its
// sequence's literals in the ring or from the window, chosen by compares
// and selects, and stores it under a predicate.  Any other sequence takes
// the general copies (qz_lz4_copy_literals, qz_lz4_copy_match).  The next
// group's records are loaded before the current group's bytes.
template <class W>
__host__ __device__ inline void qz_lz4_consume(const QzLz4In& in, int slot,
                                               int count, uint8_t* out,
                                               int* o, W& w) {
  const QzLz4Shm& sm = in.sm;
  QzLz4Rec r[QZ_LZ4_GROUP];
  auto load = [&](int k) {
    for (int j = 0; j < QZ_LZ4_GROUP; ++j)
      r[j] = qz_lz4_ldrec(sm, slot, k + j < count ? k + j : count - 1);
  };
  if (count > 0) load(0);
  for (int k = 0; k < count;) {
    // the group: records k .. k + g - 1, record j's output at [at[j],
    // at[j + 1]) of the step (warp-uniform; no branch)
    int at[QZ_LZ4_GROUP + 1];
    int g = 0;
    at[0] = 0;
    for (int j = 0; j < QZ_LZ4_GROUP; ++j) {
      const int span = r[j].litlen + r[j].mlen;
      const int end = at[j] + span;
      const bool fits = (g == j) & (k + j < count) &
                        (end <= QZ_LZ4_LANES) &
                        ((r[j].mlen == 0) |
                         ((r[j].off >= end) &
                          (r[j].off <= QZ_LZ4_WIN - QZ_LZ4_LANES))) &
                        in.holds(r[j].lit, r[j].litlen);
      g += fits;
      at[j + 1] = fits ? end : at[j];
    }
    if (g == 0) {
      const QzLz4Rec s = r[0];
      load(k + 1);
      qz_lz4_copy_literals(in, s.lit, s.litlen, out, *o, w);
      *o += s.litlen;
      if (s.mlen > 0) {
        qz_lz4_copy_match(sm, out, *o, s.off, s.mlen, w);
        *o += s.mlen;
      }
      ++k;
      continue;
    }
    const int end = at[g];
    QzLz4Rec cur[QZ_LZ4_GROUP];
    for (int j = 0; j < QZ_LZ4_GROUP; ++j) cur[j] = r[j];
    load(k + g);
    const int o0 = *o;
    w.sync();
    w.each([&](int lane) {
      // the lane's sequence: the last j < g with at[j] <= lane
      int j0 = at[0], lit = cur[0].lit, litlen = cur[0].litlen;
      int off = cur[0].off;
      for (int j = 1; j < QZ_LZ4_GROUP; ++j) {
        const bool in_j = (j < g) & (lane >= at[j]);
        j0 = in_j ? at[j] : j0;
        lit = in_j ? cur[j].lit : lit;
        litlen = in_j ? cur[j].litlen : litlen;
        off = in_j ? cur[j].off : off;
      }
      const int d = lane - j0;
      const int from = o0 + lane - off;
      const int rv = sm.ld8(QZ_LZ4_AT_RING + ((lit + d) & (QZ_LZ4_RING - 1)));
      const int wv = sm.ld8(from & (QZ_LZ4_WIN - 1));
      const bool islit = d < litlen;
      const int v = islit ? rv : wv;
      if (lane < end) {
        if (islit)
          w.seen_input(lit + d, rv, true);
        else
          w.seen_window(from, wv);
      }
      sm.st8_if((o0 + lane) & (QZ_LZ4_WIN - 1), v, lane < end);
      qz_lz4_stg_if(out + o0 + lane, v, lane < end);
    });
    *o = o0 + end;
    k += g;
  }
}

// Row r of a launch, decoded by a CTA whose roles c gives: c.parse() and
// c.copy() say whether this thread is in the parse warp (c.pw) or the copy
// warp (c.cw), c.lead() whether it writes the row's result; c.sync() is the
// CTA barrier and c.landed() the copy warp's wait for its refills.  Round k
// parses round k's sequences into slot k & 1 while the copy warp copies
// those of round k - 1; after the barrier every thread reads round k's
// head and plans the ring for round k + 1 alike.
template <class C>
__host__ __device__ inline void qz_lz4_block(const QzLz4Args& a, int r,
                                             const QzLz4Shm& sm, C& c) {
  const uint8_t* row = a.in + (int64_t)r * a.n;
  uint8_t* out = a.out + (int64_t)r * a.outcap;
  const int len = a.len[r];
  if (len < 0 || len > a.n) {
    if (c.lead()) {
      a.tot[r] = 0;
      a.err[r] = 1;
    }
    return;
  }
  QzLz4Stage st = {0, 0, 0, 0};
  qz_lz4_stage_plan(st, 0, 0, len);
  if (c.copy()) qz_lz4_stage_issue(row, sm, len, st, c.cw);
  if (c.copy()) c.landed();
  c.sync();
  st.v0 = st.q0;
  st.v1 = st.q1;
  int p = 0, o = 0, oc = 0;   // the parse's input and output, the copy's
  int count = 0;              // records of the round before
  int last = -1;              // the block's last round, once parsed
  int tot = 0;
  bool bad = false;
  for (int k = 0;; ++k) {
    const QzLz4In in = qz_lz4_input(row, sm, len, st);
    if (c.parse() && last < 0) qz_lz4_produce(in, a, k & 1, &p, &o, c.pw);
    if (c.copy() && k > 0)
      qz_lz4_consume(in, (k - 1) & 1, count, out, &oc, c.cw);
    if (c.copy()) c.landed();
    c.sync();
    if (last >= 0) break;   // round k copied the last round's records
    const QzLz4Head h = qz_lz4_ldhead(sm, k & 1);
    count = h.count;
    if (h.final) {
      last = k;
      tot = h.o;
      bad = h.bad != 0;
      if (bad) break;
    }
    qz_lz4_stage_plan(st, h.start, h.end, len);
    if (c.copy()) qz_lz4_stage_issue(row, sm, len, st, c.cw);
  }
  if (c.lead()) {
    a.tot[r] = tot;
    a.err[r] = bad;
  }
}
