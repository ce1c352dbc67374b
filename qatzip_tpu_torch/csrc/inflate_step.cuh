// The lockstep DEFLATE entropy decoder: one lane's work.
//
// The logic of qatzip_tpu/ops/pallas_inflate.py:decode_step (:244-329) and
// of its XLA driver _decode_xla (:335-387) for ONE lane, in uint32
// arithmetic, over the 9-bit region layout (region_spec(False)): a lane's
// litlen and distance regions are 512 u32 cells each, cells 0..255 the
// 9-bit root (u16 entries packed two per cell) and cells 256..511 the
// subtable area.  Entry and token formats are documented at
// qatzip_tpu_torch/ops/inflate.py.
//
// Layout on the card (csrc/inflate.cu): one CTA a lane.  Its warp copies
// the lane's two regions into shared memory, one u16 entry a u32 word and
// widened with what the step would otherwise compute from the entry after
// the lookup (a length's base and extra bits, a distance's); then one
// thread decodes.  The three stream words the step peeks at live in
// registers, with the next two prefetched, so a step loads a word only
// when the lane crosses into it.  Each kind of symbol takes its own
// branch, so a step's dependent chain is two shared-memory lookups (litlen
// root, then the paired literal's root or the distance's) and a few dozen
// integer operations; a subtable lookup is taken only by a code longer
// than 9 bits.  A lane runs alone in its warp, so no branch diverges.
//
// __host__ __device__ so that g++ builds the same code for the CPU tests
// (tests/test_torch_csrc_host.py), which run a launch's threads serially.
#pragma once
#include <stdint.h>

#define QZ_CELLS 512
#define QZ_ROOT_BITS 9
#define QZ_ENTRIES (2 * QZ_CELLS)   // u16 entries of a region: root, then sub
#define QZ_CTA_THREADS 32           // a CTA: one warp stages, one thread decodes
#define QZ_SMEM_WORDS (2 * QZ_ENTRIES)  // a lane's widened entries, 8 KB

// Widened entries: bits 0..15 the region's u16 entry, and above them
//   litlen:   16..18 a length's extra bits, 19..27 its base (0 for others)
//   distance: 16..19 extra bits, 20..21 the base's leading bits m (the base
//             minus one is m << extra bits), 22 set for an entry that is not
//             a valid distance (0, or kind != 0)
#define QZ_DIST_BAD (1u << 22)

#ifdef __CUDA_ARCH__
#define QZ_LDG(p) __ldg(p)
#else
#define QZ_LDG(p) (*(p))
#endif

// One launch's arguments; every per-lane array has `lanes` rows.
struct QzInflateArgs {
  const uint32_t* words;  // stream words, [lanes, nw]
  int nw;                 // words a lane (>= 3)
  const int32_t* bit0;    // first bit of the block in word 0
  const int32_t* nbits;   // stream bits a lane
  const uint32_t* tll;    // litlen regions, [lanes, QZ_CELLS]
  const uint32_t* td;     // distance regions, [lanes, QZ_CELLS]
  const int32_t* active;  // lanes that decode
  int lanes;
  int max_steps;
  uint32_t* tokens;       // [max_steps, lanes], zero-filled by the caller
  int32_t* err;
  int32_t* outcnt;
  int32_t* end_bit;
};

struct QzState {
  int32_t bitpos;
  bool done;
  bool err;
  int32_t outcnt;
  int32_t end_bit;
};

// The stream words the step peeks at, in registers.  wi is the driver's
// clamped word index min(bitpos >> 5, nw - 3); w0..w2 are words wi..wi+2
// and p0/p1 words wi+3 and wi+4, loaded a step before they are needed
// (their index is clamped to the last word, whose value is then never used).
struct QzBits {
  const uint32_t* words;
  int nw;
  int wi;
  uint32_t w0, w1, w2, p0, p1;
};

// (1 << n) - 1 for n < 32 (every caller passes n <= 15)
__host__ __device__ inline uint32_t qz_mask(uint32_t n) {
  return (1u << n) - 1u;
}

// (hi:lo) >> sh for sh < 32, the low word
__host__ __device__ inline uint32_t qz_funnel(uint32_t lo, uint32_t hi,
                                              uint32_t sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return (lo >> sh) | ((hi << (31u - sh)) << 1);
#endif
}

// -- staging ----------------------------------------------------------------

__host__ __device__ inline uint32_t qz_widen_ll(uint32_t e) {
  if (((e >> 4) & 3u) != 1u) return e;
  // length base/extra closed form of symbol index sym 0..28
  const int32_t sym = (int32_t)((e >> 6) & 0xFFu);
  int32_t e_len = (sym - 4 > 0 ? sym - 4 : 0) >> 2;
  e_len = e_len < 5 ? e_len : 5;
  int32_t lbase = sym < 4 ? sym + 3 : ((4 + (sym & 3)) << e_len) + 3;
  if (sym >= 28) {
    e_len = 0;
    lbase = 258;
  }
  return e | ((uint32_t)e_len << 16) | (((uint32_t)lbase & 0x1FFu) << 19);
}

__host__ __device__ inline uint32_t qz_widen_d(uint32_t e) {
  // dist base closed form: s<4 -> base-1=s, e=0; else e=(s-2)>>1,
  // base-1 = (2+(s&1))<<e
  const int32_t ds = (int32_t)((e >> 6) & 31u);
  const int32_t e_d = (ds - 2 > 0 ? ds - 2 : 0) >> 1;
  const uint32_t deb = ds < 4 ? 0u : (uint32_t)e_d;
  const uint32_t m = ds < 4 ? (uint32_t)ds : 2u + (uint32_t)(ds & 1);
  const bool bad = (e == 0u) || (((e >> 4) & 3u) != 0u);
  return e | (deb << 16) | (m << 20) | (bad ? QZ_DIST_BAD : 0u);
}

// Thread t of the lane's CTA widens its share of the two regions' cells
// into smem: litlen entries at [0, QZ_ENTRIES), distance entries after.
__host__ __device__ inline void qz_stage_tables(const QzInflateArgs& a,
                                                int lane, int t,
                                                uint32_t* smem) {
  const uint32_t* gll = a.tll + (int64_t)lane * QZ_CELLS;
  const uint32_t* gdt = a.td + (int64_t)lane * QZ_CELLS;
  for (int c = t; c < QZ_CELLS; c += QZ_CTA_THREADS) {
    const uint32_t ll = QZ_LDG(gll + c), dt = QZ_LDG(gdt + c);
    smem[2 * c] = qz_widen_ll(ll & 0xFFFFu);
    smem[2 * c + 1] = qz_widen_ll(ll >> 16);
    smem[QZ_ENTRIES + 2 * c] = qz_widen_d(dt & 0xFFFFu);
    smem[QZ_ENTRIES + 2 * c + 1] = qz_widen_d(dt >> 16);
  }
}

// -- stream window ----------------------------------------------------------

__host__ __device__ inline uint32_t qz_word(const uint32_t* words, int nw,
                                            int i) {
  return QZ_LDG(words + (i < nw ? i : nw - 1));
}

__host__ __device__ inline int qz_word_index(int nw, int32_t bitpos) {
  const int wi = bitpos >> 5;
  return wi < 0 ? 0 : (wi > nw - 3 ? nw - 3 : wi);
}

__host__ __device__ inline void qz_bits_init(QzBits* b, const uint32_t* words,
                                             int nw, int32_t bitpos) {
  b->words = words;
  b->nw = nw;
  b->wi = qz_word_index(nw, bitpos);
  b->w0 = qz_word(words, nw, b->wi);
  b->w1 = qz_word(words, nw, b->wi + 1);
  b->w2 = qz_word(words, nw, b->wi + 2);
  b->p0 = qz_word(words, nw, b->wi + 3);
  b->p1 = qz_word(words, nw, b->wi + 4);
}

// Move the window to bitpos.  A step advances at most 49 bits (a 15-bit
// code with 5 extra bits, then a 15-bit distance code with 14), and the
// window starts at most 31 bits before the old position, so the word index
// moves by 0, 1 or 2 and the words it moves onto are p0 and p1.
__host__ __device__ inline void qz_bits_advance(QzBits* b, int32_t bitpos) {
  // bitpos only grows from a start >= 0, so only the upper clamp can bind
  const int wi = bitpos >> 5 < b->nw - 3 ? bitpos >> 5 : b->nw - 3;
  const int d = wi - b->wi;
  if (d == 0) return;
  if (d == 1) {
    b->w0 = b->w1;
    b->w1 = b->w2;
    b->w2 = b->p0;
    b->p0 = b->p1;
    b->p1 = qz_word(b->words, b->nw, wi + 4);
  } else {
    b->w0 = b->w2;
    b->w1 = b->p0;
    b->w2 = b->p1;
    b->p0 = qz_word(b->words, b->nw, wi + 3);
    b->p1 = qz_word(b->words, b->nw, wi + 4);
  }
  b->wi = wi;
}

// -- the step ---------------------------------------------------------------

__host__ __device__ inline bool qz_is_subptr(uint32_t e) {
  return (e & 0x30u) == 0x30u;
}

// Entry for bits in a region of widened entries, given the root entry for
// their low 9 bits: that entry, or through its subtable pointer the
// subtable entry, at the reference driver's clamped cell (a subtable index
// past the area reads the last cell's half of the same parity).
__host__ __device__ inline uint32_t qz_lookup(const uint32_t* region,
                                              uint32_t root, uint32_t bits) {
  if (!qz_is_subptr(root)) return root;
  const int sidx = (int)(((root >> 6) & 0xFFu) << 1) +
                   (int)((bits >> QZ_ROOT_BITS) & qz_mask(root & 15u));
  const int last = QZ_ENTRIES - QZ_CELLS - 2 + (sidx & 1);
  return region[QZ_CELLS + (sidx < last ? sidx : last)];
}

// One symbol decode (plus a paired second root literal) from the 64 stream
// bits b0|b1 at st.bitpos, over the lane's widened entries (litlen ll,
// distance dt), for a lane not yet done.  Returns the step's token and
// advances st.
__host__ __device__ inline uint32_t qz_decode_step(const uint32_t* ll,
                                                   const uint32_t* dt,
                                                   uint32_t b0, uint32_t b1,
                                                   QzState& st) {
  const uint32_t root = ll[b0 & qz_mask(QZ_ROOT_BITS)];
  const uint32_t e = qz_lookup(ll, root, b0);
  const uint32_t clen = e & 15u;
  if ((e & 0x30u) == 0u) {  // kind 0: a literal, or 0 (invalid)
    if ((e & 0xFFFFu) == 0u) {
      st.err = st.done = true;
      return 0u;
    }
    // literal pairing: a root-resolved literal followed by another root
    // literal decodes both in this step (bit 9 flag, byte in bits 10..17)
    uint32_t token = 1u | (((e >> 6) & 0xFFu) << 1);
    uint32_t adv = clen;
    st.outcnt += 1;
    if (!qz_is_subptr(root)) {
      const uint32_t e2 = ll[(b0 >> clen) & qz_mask(QZ_ROOT_BITS)];
      if ((e2 & 0xFFFFu) != 0u && (e2 & 0x30u) == 0u) {
        token += 0x200u | (((e2 >> 6) & 0xFFu) << 10);
        adv += e2 & 15u;
        st.outcnt += 1;
      }
    }
    st.bitpos += (int32_t)adv;
    return token;
  }
  if (e & 0x20u) {  // kind 2: end of block; kind 3: unresolved subptr
    if (e & 0x10u) {
      st.err = st.done = true;
      return 0u;
    }
    st.end_bit = st.bitpos + (int32_t)clen;
    st.bitpos = st.end_bit;
    st.done = true;
    return 0u;
  }
  // a length (extra bits and base widened into e), then its distance
  const uint32_t eb = (e >> 16) & 7u;
  const int32_t mlen =
      (int32_t)(((e >> 19) & 0x1FFu) + ((b0 >> clen) & qz_mask(eb)));
  const uint32_t used1 = clen + eb;  // <= 20 bits
  const uint32_t bits2 = qz_funnel(b0, b1, used1);
  const uint32_t ed = qz_lookup(dt, dt[bits2 & qz_mask(QZ_ROOT_BITS)], bits2);
  if (ed & QZ_DIST_BAD) {
    st.err = st.done = true;
    return 0u;
  }
  const uint32_t dclen = ed & 15u;
  const uint32_t deb = (ed >> 16) & 15u;
  const uint32_t dist1 =
      (((ed >> 20) & 3u) << deb) + ((bits2 >> dclen) & qz_mask(deb));
  st.outcnt += mlen;
  st.bitpos += (int32_t)(used1 + dclen + deb);
  return 2u | ((uint32_t)mlen << 2) | (dist1 << 11);
}

// Decode one lane from its staged entries (smem) until EOB, error or
// max_steps.  The token of step s goes to tokens[s * lanes + lane]; steps
// after the lane finished are not written.  Returns the steps taken,
// counting the step that finished the lane.
__host__ __device__ inline int qz_inflate_lane(const QzInflateArgs& a,
                                               int lane,
                                               const uint32_t* smem) {
  const uint32_t* ll = smem;
  const uint32_t* dt = smem + QZ_ENTRIES;
  const bool active0 = a.active[lane] != 0;
  QzState st = {a.bit0[lane], !active0, false, 0, -1};
  QzBits bits;
  qz_bits_init(&bits, a.words + (int64_t)lane * a.nw, a.nw, st.bitpos);
  uint32_t* token = a.tokens + lane;
  int s = 0;
  while (s < a.max_steps && !st.done) {
    const uint32_t sh = (uint32_t)(st.bitpos & 31);
    const uint32_t b0 = qz_funnel(bits.w0, bits.w1, sh);
    const uint32_t b1 = qz_funnel(bits.w1, bits.w2, sh);
    *token = qz_decode_step(ll, dt, b0, b1, st);
    token += a.lanes;
    qz_bits_advance(&bits, st.bitpos);
    ++s;
  }
  // a lane undone at max_steps, past its stream, or without an EOB is
  // decoded on the CPU instead
  bool e = st.err || (active0 && !st.done) ||
           (active0 && st.bitpos > a.nbits[lane]);
  e = e || (active0 && st.end_bit < 0);
  a.err[lane] = e ? 1 : 0;
  a.outcnt[lane] = st.outcnt;
  a.end_bit[lane] = st.end_bit;
  return s;
}
