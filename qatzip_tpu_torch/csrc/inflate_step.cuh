// One lane of the lockstep DEFLATE entropy decoder.
//
// The logic of qatzip_tpu/ops/pallas_inflate.py:decode_step (:244-329) and
// of its XLA driver _decode_xla (:335-387) for ONE lane, in uint32
// arithmetic, over the 9-bit region layout (region_spec(False)): a lane's
// litlen and distance tables are 512 u32 cells each, cells 0..255 the
// 9-bit root (u16 entries packed two per cell) and cells 256..511 the
// subtable area.  Entry and token formats are documented at
// qatzip_tpu_torch/ops/inflate.py.
//
// __host__ __device__ so that g++ builds the same code for the CPU tests
// (tests/test_torch_csrc_host.py).
#pragma once
#include <stdint.h>

#define QZ_CELLS 512
#define QZ_ROOT_BITS 9
#define QZ_SUB_BASE 256

struct QzLane {
  const uint32_t* words;  // this lane's stream words
  int nw;                 // words per lane (>= 3)
  const uint32_t* tll;    // litlen region, QZ_CELLS cells
  const uint32_t* td;     // distance region, QZ_CELLS cells
};

struct QzState {
  int32_t bitpos;
  bool done;
  bool err;
  int32_t outcnt;
  int32_t end_bit;
};

// (1 << n) - 1 for n < 32 (every caller passes n <= 15)
__host__ __device__ inline uint32_t qz_mask(uint32_t n) {
  return (1u << n) - 1u;
}

// table cell with the reference driver's index clamp
__host__ __device__ inline uint32_t qz_cell(const uint32_t* tbl, int idx) {
  idx = idx < 0 ? 0 : (idx > QZ_CELLS - 1 ? QZ_CELLS - 1 : idx);
  return tbl[idx];
}

// root-level u16 entry for the low QZ_ROOT_BITS of bits
__host__ __device__ inline uint32_t qz_root_entry(const uint32_t* tbl,
                                                  uint32_t bits) {
  const uint32_t idx = bits & qz_mask(QZ_ROOT_BITS);
  const uint32_t cell = qz_cell(tbl, (int)(idx >> 1));
  return (cell >> ((idx & 1u) << 4)) & 0xFFFFu;
}

// root + subtable lookup; *at_root tells whether the root resolved it
__host__ __device__ inline uint32_t qz_resolve(const uint32_t* tbl,
                                               uint32_t bits, bool* at_root) {
  const uint32_t e = qz_root_entry(tbl, bits);
  const bool is_sub = ((e >> 4) & 3u) == 3u;
  const uint32_t subbits = e & 15u;
  const int sidx = (int)(((e >> 6) & 0xFFu) << 1) +
                   (int)((bits >> QZ_ROOT_BITS) & qz_mask(subbits));
  const uint32_t cell2 = qz_cell(tbl, QZ_SUB_BASE + (sidx >> 1));
  const uint32_t e2 = (cell2 >> (((uint32_t)sidx & 1u) << 4)) & 0xFFFFu;
  *at_root = !is_sub;
  return is_sub ? e2 : e;
}

// next 64 stream bits at bitpos as two words (word index clamped as in
// the reference driver); (w << (31 - sh)) << 1 avoids a shift by 32
__host__ __device__ inline void qz_peek2(const uint32_t* words, int nw,
                                         int32_t bitpos, uint32_t* b0,
                                         uint32_t* b1) {
  int wi = bitpos >> 5;
  wi = wi < 0 ? 0 : (wi > nw - 3 ? nw - 3 : wi);
  const uint32_t sh = (uint32_t)(bitpos & 31);
  const uint32_t w0 = words[wi], w1 = words[wi + 1], w2 = words[wi + 2];
  *b0 = (w0 >> sh) | ((w1 << (31u - sh)) << 1);
  *b1 = (w1 >> sh) | ((w2 << (31u - sh)) << 1);
}

// One symbol decode (plus a paired second root literal).  Returns the
// step's token and advances st.
__host__ __device__ inline uint32_t qz_decode_step(const QzLane& L,
                                                   QzState& st) {
  uint32_t b0, b1;
  qz_peek2(L.words, L.nw, st.bitpos, &b0, &b1);
  bool at_root;
  const uint32_t e = qz_resolve(L.tll, b0, &at_root);
  const int32_t clen = (int32_t)(e & 15u);
  const int32_t kind = (int32_t)((e >> 4) & 3u);
  bool bad = (e == 0u) || (kind == 3);  // unresolved subptr = corrupt
  bool islit = (kind == 0) && !bad;
  bool islen = kind == 1;
  const bool iseob = kind == 2;
  const int32_t sym = (int32_t)((e >> 6) & 0xFFu);
  // length base/extra closed form; the clamp keeps the shift count < 32
  // on literal lanes, whose byte flows through sym
  int32_t e_len = (sym - 4 > 0 ? sym - 4 : 0) >> 2;
  e_len = e_len < 5 ? e_len : 5;
  int32_t lbase = sym < 4 ? sym + 3 : ((4 + (sym & 3)) << e_len) + 3;
  if (sym >= 28) {
    e_len = 0;
    lbase = 258;
  }
  const int32_t eb = islen ? e_len : 0;
  const int32_t lex = (int32_t)((b0 >> (uint32_t)clen) & qz_mask((uint32_t)eb));
  const int32_t mlen = lbase + lex;
  const int32_t used1 = clen + eb;  // <= 20 bits
  const uint32_t u1 = (uint32_t)used1;
  const uint32_t bits2 = (b0 >> u1) | ((b1 << (31u - u1)) << 1);

  bool d_at_root;
  const uint32_t ed = qz_resolve(L.td, bits2, &d_at_root);
  const int32_t dclen = (int32_t)(ed & 15u);
  const bool dbad = (ed == 0u) || (((ed >> 4) & 3u) != 0u);
  const int32_t ds = (int32_t)((ed >> 6) & 31u);
  const int32_t e_d = (ds - 2 > 0 ? ds - 2 : 0) >> 1;
  const int32_t dbase1 = ds < 4 ? ds : ((2 + (ds & 1)) << e_d);
  const int32_t deb = ds < 4 ? 0 : e_d;
  const int32_t dex =
      (int32_t)((bits2 >> (uint32_t)dclen) & qz_mask((uint32_t)deb));
  const int32_t dist1 = dbase1 + dex;

  bad = bad || (islen && dbad);
  islen = islen && !bad;
  islit = islit && !bad;

  const bool active = !st.done && !st.err;
  uint32_t token = 0u;
  if (active && islit) token += 1u | ((uint32_t)sym << 1);
  if (active && islen)
    token += 2u | ((uint32_t)mlen << 2) | ((uint32_t)dist1 << 11);

  // literal pairing: a root-resolved literal followed by another root
  // literal decodes both in this step (bit 9 flag, byte in bits 10..17)
  const bool pair = active && islit && at_root;
  const uint32_t e2 = qz_root_entry(L.tll, b0 >> (uint32_t)clen);
  const bool lit2 = pair && (e2 != 0u) && (((e2 >> 4) & 3u) == 0u);
  const int32_t clen2 = (int32_t)(e2 & 15u);
  const uint32_t sym2 = (e2 >> 6) & 0xFFu;
  if (lit2) token += 0x200u | (sym2 << 10);

  if (active && iseob) st.end_bit = st.bitpos + used1;
  st.outcnt += (int32_t)(active && islit) + (int32_t)lit2 +
               (active && islen ? mlen : 0);
  const int32_t adv = used1 + (islen ? dclen + deb : 0) + (lit2 ? clen2 : 0);
  if (active) st.bitpos += adv;
  st.err = st.err || (active && bad);
  st.done = st.done || (active && (iseob || bad));
  return token;
}

// Decode one lane from bit0 until EOB, error or max_steps.  The token of
// step s goes to tokens[s * lanes + lane]; steps after the lane finished
// are not written (the caller zero-fills).  Returns the steps taken,
// counting the step that finished the lane.
__host__ __device__ inline int qz_inflate_lane(const QzLane& L, int32_t bit0,
                                               int32_t nbits, bool active0,
                                               int max_steps,
                                               uint32_t* tokens, int lanes,
                                               int lane, int32_t* err,
                                               int32_t* outcnt,
                                               int32_t* end_bit) {
  QzState st = {bit0, !active0, false, 0, -1};
  int s = 0;
  while (s < max_steps && !(st.done || st.err)) {
    tokens[(int64_t)s * lanes + lane] = qz_decode_step(L, st);
    ++s;
  }
  // a lane undone at max_steps, past its stream, or without an EOB is
  // decoded on the CPU instead
  bool e = st.err || (active0 && !st.done) || (active0 && st.bitpos > nbits);
  e = e || (active0 && st.end_bit < 0);
  *err = e ? 1 : 0;
  *outcnt = st.outcnt;
  *end_bit = st.end_bit;
  return s;
}
