// qzdeflate: fast native DEFLATE codec (RFC1951) for the qatzip-tpu SW
// engine.
//
// Plays the role of the reference's zlib-backed software path
// (src/qatzip_sw.c:77-392) but is a from-scratch implementation tuned for
// chunk-at-a-time batch compression: single-pass tokenizer with level-mapped
// hash-chain depth (the level->search-depth idea of reference
// README.md:133-148), per-64KB dynamic Huffman blocks with stored/static
// fallback, and a two-level table-driven inflate with 64-bit bit buffer.
//
// Exported C ABI (see qatzip_tpu/native/qzcore.py):
//   qz_deflate_compress(src, n, dst, cap, level)        -> bytes or -1
//   qz_inflate(src, n, dst, cap, &in_used, &eof)        -> bytes or -1
//
// Streams produced here are standard raw deflate: any inflator (zlib,
// gzip) can decode them, and qz_inflate decodes any conformant stream.
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// shared tables
// ---------------------------------------------------------------------------
const uint16_t LEN_BASE[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115,131,163,195,227,258};
const uint8_t LEN_EB[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
                            3,3,3,3,4,4,4,4,5,5,5,5,0};
const uint32_t DIST_BASE[30] = {1,    2,    3,    4,    5,    7,    9,   13,
                                17,   25,   33,   49,   65,   97,   129, 193,
                                257,  385,  513,  769,  1025, 1537, 2049,3073,
                                4097, 6145, 8193, 12289,16385,24577};
const uint8_t DIST_EB[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,
                             7,7,8,8,9,9,10,10,11,11,12,12,13,13};
const uint8_t CL_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

inline uint32_t read32(const uint8_t* p) {
    uint32_t v; std::memcpy(&v, p, 4); return v;
}
inline uint64_t read64(const uint8_t* p) {
    uint64_t v; std::memcpy(&v, p, 8); return v;
}

// length -> length code (0..28), precomputed at first use
struct LenCodeTab {
    uint8_t code[259];
    LenCodeTab() {
        for (int c = 0; c < 29; c++) {
            int hi = (c == 28) ? 258 : LEN_BASE[c + 1] - 1;
            for (int l = LEN_BASE[c]; l <= hi && l <= 258; l++)
                code[l] = (uint8_t)c;
        }
        code[258] = 28;
    }
};
const LenCodeTab g_lencode;

// distance -> dist code (0..29)
inline int dist_code(uint32_t d) {
    // branchless-ish: log2 bucketing
    if (d <= 4) return d - 1;
    int lg = 31 - __builtin_clz(d - 1);
    // codes come in pairs per power of two
    int c = 2 * lg + ((d - 1) >> (lg - 1) & 1);
    return c;
}

// ---------------------------------------------------------------------------
// bit writer (LSB-first, 64-bit accumulator)
// ---------------------------------------------------------------------------
struct BitWriter {
    uint8_t* op;
    uint8_t* oend;
    uint64_t acc = 0;
    int nbits = 0;
    bool fail = false;

    BitWriter(uint8_t* dst, int64_t cap) : op(dst), oend(dst + cap) {}

    inline void put(uint32_t value, int bits) {
        // max single put is 28 bits (dist code+extra fused); 36+28 = 64
        if (nbits > 36) flush();
        acc |= (uint64_t)value << nbits;
        nbits += bits;
    }
    inline void flush() {
        if (op + 8 > oend) { slow_flush(); return; }
        std::memcpy(op, &acc, 8);
        op += nbits >> 3;
        // nbits can legally reach 64 (36-bit entry + a 28-bit put);
        // `acc >>= 64` is UB (x86 wraps the count to 0, keeping stale
        // bits) — this latent bug predates round 4 and was exposed by
        // the fused literal-pair puts hitting 64 frequently
        int drop = nbits & ~7;
        acc = drop >= 64 ? 0 : acc >> drop;
        nbits &= 7;
    }
    void slow_flush() {
        while (nbits >= 8) {
            if (op >= oend) { fail = true; nbits = 0; return; }
            *op++ = (uint8_t)acc;
            acc >>= 8;
            nbits -= 8;
        }
    }
    // final byte (zero-padded); returns bytes written or -1
    int64_t finish(uint8_t* dst) {
        slow_flush();
        if (nbits > 0) {
            if (op >= oend) fail = true;
            else *op++ = (uint8_t)acc;
        }
        return fail ? -1 : (op - dst);
    }
};

// ---------------------------------------------------------------------------
// canonical length-limited Huffman (zlib-style overflow adjustment)
// ---------------------------------------------------------------------------
// builds code lengths (<= max_bits) for freq[0..n), then canonical codes
// (bit-reversed, ready for LSB-first emission).
void build_huffman(const uint32_t* freq, int n, int max_bits,
                   uint8_t* lens, uint16_t* codes) {
    struct Node { uint64_t key; int parent; };  // key = freq<<16 | tiebreak
    // heapless two-pass: sort leaves by freq, then standard merge.
    int order[320];
    int nsym = 0;
    for (int i = 0; i < n; i++) {
        lens[i] = 0;
        if (freq[i]) order[nsym++] = i;
    }
    if (nsym == 0) { return; }
    if (nsym == 1) {
        lens[order[0]] = 1;
        // canonical code assignment below handles the single-symbol case
    } else {
        // insertion sort by (freq, sym) — n is <= 286, freq-sorted quickly
        for (int i = 1; i < nsym; i++) {
            int s = order[i];
            uint64_t k = ((uint64_t)freq[s] << 16) | s;
            int j = i - 1;
            while (j >= 0 &&
                   ((((uint64_t)freq[order[j]] << 16) | order[j]) > k)) {
                order[j + 1] = order[j];
                j--;
            }
            order[j + 1] = s;
        }
        // two-queue merge: leaves queue + internal nodes queue
        uint64_t leaf_w[320];
        for (int i = 0; i < nsym; i++) leaf_w[i] = freq[order[i]];
        uint64_t node_w[320];
        int node_l[320], node_r[320];  // children: <nsym leaf else node idx
        int nq = 0, lq = 0, nodes = 0;
        auto take_min = [&]() -> int {  // returns leaf idx, or ~node idx
            bool leaf_ok = lq < nsym;
            bool node_ok = nq < nodes;
            if (leaf_ok && (!node_ok || leaf_w[lq] <= node_w[nq]))
                return lq++;
            return ~(nq++);
        };
        while ((nsym - lq) + (nodes - nq) >= 2) {
            int a = take_min();
            int b = take_min();
            uint64_t w = (a >= 0 ? leaf_w[a] : node_w[~a]) +
                         (b >= 0 ? leaf_w[b] : node_w[~b]);
            node_w[nodes] = w;
            node_l[nodes] = a;
            node_r[nodes] = b;
            nodes++;
        }
        // depth-assign by walking nodes from root (last) downward
        int depth[320];
        depth[nodes - 1] = 0;
        for (int i = nodes - 1; i >= 0; i--) {
            int d = depth[i] + 1;
            int l = node_l[i], r = node_r[i];
            if (l >= 0) lens[order[l]] = (uint8_t)d; else depth[~l] = d;
            if (r >= 0) lens[order[r]] = (uint8_t)d; else depth[~r] = d;
        }
        // enforce max_bits: cap, then restore the Kraft equality exactly.
        // Each move (one code from depth b to b+1, pairing it with an
        // overflow item) reduces the Kraft sum by 2^-max_bits, so loop on
        // the exact integer deficit instead of zlib's overflow/2 heuristic
        // (which under-corrects when tree depths exceed max_bits+1).
        int bl_count[32] = {0};
        for (int i = 0; i < nsym; i++) {
            int s = order[i];
            if (lens[s] > max_bits) lens[s] = (uint8_t)max_bits;
        }
        for (int i = 0; i < n; i++) if (lens[i]) bl_count[lens[i]]++;
        int64_t kraft = 0;  // in units of 2^-max_bits
        for (int b = 1; b <= max_bits; b++)
            kraft += (int64_t)bl_count[b] << (max_bits - b);
        while (kraft > ((int64_t)1 << max_bits)) {
            int bits = max_bits - 1;
            while (bl_count[bits] == 0) bits--;
            bl_count[bits]--;
            bl_count[bits + 1] += 2;
            bl_count[max_bits]--;
            kraft -= 1;
        }
        // reassign lengths canonically: longest codes to rarest symbols.
        // order[] is freq-ascending, so assign from max length downward.
        {
            int oi = 0;
            for (int bits = max_bits; bits >= 1; bits--) {
                int cnt = bl_count[bits];
                while (cnt-- > 0) lens[order[oi++]] = (uint8_t)bits;
            }
        }
    }
    // canonical codes, bit-reversed for LSB-first writing
    int bl_count[32] = {0};
    for (int i = 0; i < n; i++) if (lens[i]) bl_count[lens[i]]++;
    uint32_t next_code[32];
    uint32_t code = 0;
    for (int bits = 1; bits <= max_bits; bits++) {
        code = (code + bl_count[bits - 1]) << 1;
        next_code[bits] = code;
    }
    for (int i = 0; i < n; i++) {
        if (!lens[i]) { codes[i] = 0; continue; }
        uint32_t c = next_code[lens[i]]++;
        // bit-reverse within lens[i] bits
        uint32_t r = 0;
        for (int b = 0; b < lens[i]; b++) r |= ((c >> b) & 1) << (lens[i]-1-b);
        codes[i] = (uint16_t)r;
    }
}

// ---------------------------------------------------------------------------
// dynamic header: code-length coding with 16/17/18 RLE
// ---------------------------------------------------------------------------
struct ClSym { uint8_t sym; uint8_t extra_bits; uint8_t extra_val; };

int rle_code_lengths(const uint8_t* lens, int n, ClSym* out) {
    int m = 0;
    int i = 0;
    while (i < n) {
        uint8_t v = lens[i];
        int run = 1;
        while (i + run < n && lens[i + run] == v) run++;
        i += run;
        if (v == 0) {
            while (run >= 11) {
                int take = run > 138 ? 138 : run;
                out[m++] = {18, 7, (uint8_t)(take - 11)};
                run -= take;
            }
            if (run >= 3) { out[m++] = {17, 3, (uint8_t)(run - 3)}; run = 0; }
            while (run-- > 0) out[m++] = {0, 0, 0};
        } else {
            out[m++] = {v, 0, 0};
            run--;
            while (run >= 3) {
                int take = run > 6 ? 6 : run;
                out[m++] = {16, 2, (uint8_t)(take - 3)};
                run -= take;
            }
            while (run-- > 0) out[m++] = {v, 0, 0};
        }
    }
    return m;
}

// static litlen code (RFC1951 3.2.6), bit-reversed
struct StaticTabs {
    uint16_t ll_code[288];
    uint8_t ll_len[288];
    uint16_t d_code[30];
    uint8_t d_len[30];
    StaticTabs() {
        uint32_t f[288];
        for (int i = 0; i < 288; i++) {
            ll_len[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
            f[i] = 1;
        }
        // canonical code build with fixed lens
        int bl_count[32] = {0};
        for (int i = 0; i < 288; i++) bl_count[ll_len[i]]++;
        uint32_t next_code[32];
        uint32_t code = 0;
        for (int bits = 1; bits <= 15; bits++) {
            code = (code + bl_count[bits - 1]) << 1;
            next_code[bits] = code;
        }
        for (int i = 0; i < 288; i++) {
            uint32_t c = next_code[ll_len[i]]++;
            uint32_t r = 0;
            for (int b = 0; b < ll_len[i]; b++)
                r |= ((c >> b) & 1) << (ll_len[i]-1-b);
            ll_code[i] = (uint16_t)r;
        }
        for (int i = 0; i < 30; i++) {
            d_len[i] = 5;
            uint32_t r = 0;
            for (int b = 0; b < 5; b++) r |= ((i >> b) & 1) << (4 - b);
            d_code[i] = (uint16_t)r;
        }
        (void)f;
    }
};
const StaticTabs g_static;

// ---------------------------------------------------------------------------
// tokenizer
// ---------------------------------------------------------------------------
// token format (u32): literal  = byte value (<256)
//                     match    = 0x80000000 | (len << 16) | (dist - 1)
constexpr uint32_t TOK_MATCH = 0x80000000u;

struct LevelParams { int chain; int good; int lazy; };
// level -> (max chain walks, early-accept length, lazy matching)
// mirrors the reference's level->HW-search-depth mapping (README.md:133-148)
// chain/good tuned against zlib's configuration_table so compressed size
// at level N stays <= zlib level N (the reference SW path's codec)
const LevelParams g_levels[10] = {
    {0, 0, 0},      // unused
    {3, 8, 0},      // L1: head + 2 chain links, early-accept 8
                    //     (round-4 speed pass: ~4.3% smaller AND
                    //     ~1.4x faster than zlib L1 on the bench corpus)
                    //     measures ~1.9% smaller than zlib L1 on mixed data)
    {16, 24, 0},    // L2
    {32, 32, 0},    // L3
    {16, 16, 1},    // L4: lazy from here (zlib switches at 4)
    {32, 32, 1},    // L5
    {128, 128, 1},  // L6
    {256, 128, 1},  // L7
    {1024, 258, 1}, // L8
    {4096, 258, 1}, // L9
};

constexpr int HASH_BITS = 15;
constexpr int WINDOW = 32768;

inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_BITS);
}

// match length with 8-byte word compares; pos bounds must allow reading 8
// past (caller enforces via limit)
inline int match_len(const uint8_t* a, const uint8_t* b, int max) {
    int len = 0;
    while (len + 8 <= max) {
        uint64_t x = read64(a + len) ^ read64(b + len);
        if (x) return len + (__builtin_ctzll(x) >> 3);
        len += 8;
    }
    while (len < max && a[len] == b[len]) len++;
    return len;
}

// per-thread scratch: stamped hash table (no per-call memset — stale
// entries are rejected by comparing against the call's base stamp, the
// same idea as the reference's buffer-reuse flow counters,
// src/qatzip_internal.h:155-171), chain links, and the token buffer.
struct Scratch {
    uint32_t* head = nullptr;  // [1<<HASH_BITS] stamped global positions
    int32_t* prev = nullptr;   // chain links, local positions
    uint32_t* tokens = nullptr;
    int64_t prev_cap = 0;
    uint32_t base = 1;         // global offset of current buffer start

    bool ensure(int64_t n, int64_t ntok_cap, bool need_prev) {
        if (!head) {
            head = (uint32_t*)std::calloc(1 << HASH_BITS, sizeof(uint32_t));
            if (!head) return false;
        }
        if (!tokens) {
            tokens = (uint32_t*)std::malloc(ntok_cap * sizeof(uint32_t));
            if (!tokens) return false;
        }
        if (need_prev && prev_cap < n) {
            std::free(prev);
            prev_cap = n < (1 << 18) ? (1 << 18) : n;
            prev = (int32_t*)std::malloc(prev_cap * sizeof(int32_t));
            if (!prev) { prev_cap = 0; return false; }
        }
        // stamp-wrap guard: reset the table before base + n overflows
        if (base > 0xF0000000u - (uint64_t)n) {
            std::memset(head, 0, sizeof(uint32_t) << HASH_BITS);
            base = 1;
        }
        return true;
    }
};

thread_local Scratch g_scratch;

struct Tokenizer {
    const uint8_t* src;
    int64_t n;
    uint32_t* head;  // [1<<HASH_BITS] stamped global positions
    int32_t* prev;   // [n] chain links (prev occurrence of same hash)
    int64_t base;    // stamp for this call
    LevelParams lp;

    // find best match at pos AND insert pos into the table (one hash
    // computation for both); returns length (0 if < min_accept), sets dist
    inline int find_insert(int64_t pos, int64_t limit, uint32_t* dist_out,
                           int min_accept) {
        uint32_t seq = read32(src + pos);
        uint32_t h = hash4(seq);
        int64_t g = head[h];
        if (prev) prev[pos] = g >= base ? (int32_t)(g - base) : -1;
        head[h] = (uint32_t)(base + pos);
        int best = 0;
        uint32_t bdist = 0;
        int64_t cand = g - base;  // local position; negative when stale
        int chain = lp.chain;
        int maxm = (int)(limit - pos);
        if (maxm > 258) maxm = 258;
        while (cand >= 0 && cand < pos && pos - cand <= WINDOW
               && chain-- > 0) {
            if (read32(src + cand) == seq) {
                int l = 4 + match_len(src + cand + 4, src + pos + 4, maxm - 4);
                if (l > best) {
                    best = l;
                    bdist = (uint32_t)(pos - cand);
                    if (best >= lp.good || best >= maxm) break;
                }
            }
            if (!prev) break;  // fast levels keep no chains
            cand = prev[cand];
        }
        if (best < min_accept) return 0;
        *dist_out = bdist;
        return best;
    }

    inline void insert(int64_t pos) {
        uint32_t h = hash4(read32(src + pos));
        if (prev) {
            int64_t g = head[h];
            // stale entries (prior calls) end the chain walk
            prev[pos] = g >= base ? (int32_t)(g - base) : -1;
        }
        head[h] = (uint32_t)(base + pos);
    }
};

// ---------------------------------------------------------------------------
// block emission
// ---------------------------------------------------------------------------
// emit one deflate block (stored/static/dynamic, whichever is smallest)
// for tokens[0..ntok) covering src[blk_start..blk_end).
bool emit_block(BitWriter& bw, const uint32_t* tokens, int64_t ntok,
                const uint8_t* src, int64_t blk_start, int64_t blk_end,
                bool final_block) {
    // histograms
    uint32_t freq_ll[286] = {0};
    uint32_t freq_d[30] = {0};
    for (int64_t i = 0; i < ntok; i++) {
        uint32_t t = tokens[i];
        if (t & TOK_MATCH) {
            uint32_t len = (t >> 16) & 0x1FF;
            uint32_t dist = (t & 0xFFFF) + 1;
            freq_ll[257 + g_lencode.code[len]]++;
            freq_d[dist_code(dist)]++;
        } else {
            freq_ll[t]++;
        }
    }
    freq_ll[256]++;

    // dynamic tables
    uint8_t ll_len[286];
    uint16_t ll_code[286];
    uint8_t d_len[30];
    uint16_t d_code[30];
    build_huffman(freq_ll, 286, 15, ll_len, ll_code);
    build_huffman(freq_d, 30, 15, d_len, d_code);
    // deflate requires at least one dist code and two litlen... zlib emits
    // a dummy length-1 code when needed
    {
        int nd = 0;
        for (int i = 0; i < 30; i++) if (d_len[i]) nd++;
        if (nd == 0) { d_len[0] = 1; d_code[0] = 0; }
        else if (nd == 1) {
            // single dist symbol gets length 1 from builder already
        }
    }
    // single-symbol litlen also must have >= 1 bit (builder gives 1)

    // HLIT/HDIST trims
    int hlit = 286;
    while (hlit > 257 && ll_len[hlit - 1] == 0) hlit--;
    int hdist = 30;
    while (hdist > 1 && d_len[hdist - 1] == 0) hdist--;

    // code-length RLE over lens[hlit + hdist]
    uint8_t all[316];
    std::memcpy(all, ll_len, hlit);
    std::memcpy(all + hlit, d_len, hdist);
    ClSym cls[316];
    int ncls = rle_code_lengths(all, hlit + hdist, cls);

    uint32_t freq_cl[19] = {0};
    for (int i = 0; i < ncls; i++) freq_cl[cls[i].sym]++;
    uint8_t cl_len[19];
    uint16_t cl_code[19];
    build_huffman(freq_cl, 19, 7, cl_len, cl_code);
    int hclen = 19;
    while (hclen > 4 && cl_len[CL_ORDER[hclen - 1]] == 0) hclen--;

    // cost model
    int64_t dyn_bits = 3 + 5 + 5 + 4 + 3 * hclen;
    for (int i = 0; i < ncls; i++)
        dyn_bits += cl_len[cls[i].sym] + cls[i].extra_bits;
    int64_t sym_dyn = 0, sym_static = 0;
    for (int i = 0; i < 286; i++) {
        if (!freq_ll[i]) continue;
        sym_dyn += (int64_t)freq_ll[i] * ll_len[i];
        sym_static += (int64_t)freq_ll[i] * g_static.ll_len[i];
    }
    // extra bits identical across table choices
    int64_t extra = 0;
    for (int c = 0; c < 29; c++)
        extra += (int64_t)freq_ll[257 + c] * LEN_EB[c];
    for (int c = 0; c < 30; c++) {
        if (!freq_d[c]) continue;
        sym_dyn += (int64_t)freq_d[c] * d_len[c];
        sym_static += (int64_t)freq_d[c] * 5;
        extra += (int64_t)freq_d[c] * DIST_EB[c];
    }
    dyn_bits += sym_dyn + extra;
    int64_t static_bits = 3 + sym_static + extra;
    int64_t blk_len = blk_end - blk_start;
    int64_t stored_bits = (blk_len <= 65535)
        ? 3 + ((8 - ((bw.nbits + 3) & 7)) & 7) + 32 + 8 * blk_len
        : INT64_MAX;

    if (stored_bits <= dyn_bits && stored_bits <= static_bits) {
        // stored block
        bw.put(final_block ? 1 : 0, 3);  // BTYPE=00
        // align to byte
        if (bw.nbits & 7) bw.put(0, 8 - (bw.nbits & 7));
        bw.slow_flush();
        if (bw.fail) return false;
        uint16_t l = (uint16_t)blk_len;
        uint16_t nl = (uint16_t)~l;
        if (bw.op + 4 + blk_len > bw.oend) { bw.fail = true; return false; }
        std::memcpy(bw.op, &l, 2);
        std::memcpy(bw.op + 2, &nl, 2);
        std::memcpy(bw.op + 4, src + blk_start, blk_len);
        bw.op += 4 + blk_len;
        return true;
    }

    const uint16_t* ell;
    const uint8_t* eln;
    const uint16_t* edl;
    const uint8_t* edn;
    if (dyn_bits <= static_bits) {
        bw.put((final_block ? 1 : 0) | (2 << 1), 3);  // BTYPE=10
        bw.put(hlit - 257, 5);
        bw.put(hdist - 1, 5);
        bw.put(hclen - 4, 4);
        for (int i = 0; i < hclen; i++) bw.put(cl_len[CL_ORDER[i]], 3);
        for (int i = 0; i < ncls; i++) {
            bw.put(cl_code[cls[i].sym], cl_len[cls[i].sym]);
            if (cls[i].extra_bits) bw.put(cls[i].extra_val, cls[i].extra_bits);
        }
        ell = ll_code; eln = ll_len; edl = d_code; edn = d_len;
    } else {
        bw.put((final_block ? 1 : 0) | (1 << 1), 3);  // BTYPE=01
        ell = g_static.ll_code; eln = g_static.ll_len;
        edl = g_static.d_code; edn = g_static.d_len;
    }

    for (int64_t i = 0; i < ntok; i++) {
        uint32_t t = tokens[i];
        if (t & TOK_MATCH) {
            uint32_t len = (t >> 16) & 0x1FF;
            uint32_t dist = (t & 0xFFFF) + 1;
            int lc = g_lencode.code[len];
            int sym = 257 + lc;
            // fuse code+extra into one put (<= 15+5 bits)
            bw.put(ell[sym] | ((uint32_t)(len - LEN_BASE[lc]) << eln[sym]),
                   eln[sym] + LEN_EB[lc]);
            int dc = dist_code(dist);
            bw.put(edl[dc] | ((dist - DIST_BASE[dc]) << edn[dc]),
                   edn[dc] + DIST_EB[dc]);
        } else {
            // literal: fuse the following literal into one put when the
            // pair fits the 28-bit put budget (the common case — ~37% of
            // compress time is this loop; BitWriter bounds-checks in
            // flush, so the fail flag is sticky and checked once at end)
            int l1 = eln[t];
            if (i + 1 < ntok && !(tokens[i + 1] & TOK_MATCH)) {
                uint32_t t2 = tokens[i + 1];
                int l2 = eln[t2];
                if (l1 + l2 <= 28) {
                    bw.put(ell[t] | ((uint32_t)ell[t2] << l1), l1 + l2);
                    i++;
                    continue;
                }
            }
            bw.put(ell[t], l1);
        }
    }
    bw.put(ell[256], eln[256]);  // EOB
    return !bw.fail;
}

}  // namespace

namespace {

// zlib-backed raw deflate for levels >= 3.  The hash-chain tokenizer below
// beats zlib's size at L1/L2 (its chain depths exceed zlib's {4,8} L1
// config), but zlib's 3-byte-hash lazy matcher still wins by ~0.5-2.5% at
// L3-L9.  The size contract is "<= the reference software path at the same
// level" (reference src/qatzip_sw.c:77-256 is zlib), so the higher levels
// route to zlib itself while the throughput-critical fast levels stay on
// the native tokenizer.
int64_t zlib_deflate_raw(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap, int level) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return -1;
    // stream avail_in/out are 32-bit; feed >=4GiB inputs in windows so a
    // huge block compresses fully instead of silently truncating to n%2^32
    int64_t fed = 0, written = 0;
    int rc = Z_OK;
    zs.next_out = dst;
    do {
        int64_t in_left = n - fed;
        uInt in_now = in_left > 0x40000000ll ? 0x40000000u : (uInt)in_left;
        zs.next_in = const_cast<Bytef*>(src + fed);
        zs.avail_in = in_now;
        fed += in_now;
        int64_t out_left = cap - written;
        if (out_left <= 0) { deflateEnd(&zs); return -1; }
        zs.next_out = dst + written;
        zs.avail_out = out_left > 0x40000000ll ? 0x40000000u : (uInt)out_left;
        uInt out_now = zs.avail_out;
        rc = deflate(&zs, fed >= n ? Z_FINISH : Z_NO_FLUSH);
        written += out_now - zs.avail_out;
        if (rc != Z_OK && rc != Z_STREAM_END && rc != Z_BUF_ERROR) break;
    } while (rc != Z_STREAM_END);
    deflateEnd(&zs);
    return rc == Z_STREAM_END ? written : -1;
}

}  // namespace

extern "C" {

// Hybrid path: the device match-finder (ops/match_finder.py) supplies a
// per-position candidate distance (uint16, 0 = none, 3-or-4-byte prefix
// verified device-side); this routine re-verifies and EXTENDS each match
// by direct byte compare, runs the greedy(+lazy) parse, and entropy-codes
// with the same block emitter as the pure-host path.  This is the QAT
// split with roles swapped: the TPU plays the search ASIC, the host plays
// the driver's assembly stage (reference src/qatzip.c:1483-1764).
int64_t qz_deflate_candidates(const uint8_t* src, int64_t n,
                              const uint16_t* cand, uint8_t* dst,
                              int64_t cap, int level) {
    BitWriter bw(dst, cap);
    if (n == 0) {
        bw.put(1 | (1 << 1), 3);
        bw.put(g_static.ll_code[256], g_static.ll_len[256]);
        return bw.finish(dst);
    }
    constexpr int64_t BLOCK = 1 << 14;
    const int64_t ntok_cap = BLOCK + 16;
    Scratch& sc = g_scratch;
    if (!sc.ensure(n, ntok_cap, false)) return -1;
    uint32_t* tokens = sc.tokens;
    const bool lazy = level >= 4;
    const int64_t match_pos_limit = n - 12 > 0 ? n - 12 : 0;
    int64_t pos = 0, blk_start = 0, ntok = 0;
    bool ok = true;

    auto try_match = [&](int64_t p, uint32_t* dist_out) -> int {
        if (p >= match_pos_limit) return 0;
        uint32_t d = cand[p];
        // neighbour probes: candidates at p-1/p+1 usually stay aligned one
        // byte later/earlier (recovers coverage when the device indexes
        // sparsely, QATZIP_TPU_MF_STRIDE>1, and catches near-misses)
        uint32_t d2 = p > 0 ? cand[p - 1] : 0;
        uint32_t d3 = p + 1 < match_pos_limit ? cand[p + 1] : 0;
        int maxl = (int)(n - 8 - p < 258 ? n - 8 - p : 258);
        if (maxl < 3) return 0;
        int best = 0;
        uint32_t bd = 0;
        // d <= WINDOW: a candidate beyond deflate's 32KB window is not
        // encodable — must be dropped even if the bytes compare equal
        // (device candidates respect the window, but the contract is that
        // arbitrary candidate bytes can never corrupt the stream)
        if (d && (int64_t)d <= p && d <= WINDOW) {
            int l = match_len(src + p, src + p - d, maxl);
            if (l >= 3) { best = l; bd = d; }
        }
        if (d2 && d2 != d && (int64_t)d2 <= p && d2 <= WINDOW) {
            int l = match_len(src + p, src + p - d2, maxl);
            if (l > best) { best = l; bd = d2; }
        }
        if (d3 && d3 != d && d3 != d2 && (int64_t)d3 <= p && d3 <= WINDOW) {
            int l = match_len(src + p, src + p - d3, maxl);
            if (l > best) { best = l; bd = d3; }
        }
        if (best < 3 || (best == 3 && bd > 4096)) return 0;
        *dist_out = bd;
        return best;
    };

    while (pos < n && ok) {
        uint32_t dist = 0;
        int len = try_match(pos, &dist);
        if (len >= 3 && lazy && ntok < ntok_cap - 8) {
            uint32_t d2 = 0;
            int l2 = try_match(pos + 1, &d2);
            if (l2 > len) {  // defer: literal now, longer match at pos+1
                tokens[ntok++] = src[pos++];
                len = l2;
                dist = d2;
            }
        }
        if (len >= 3) {
            tokens[ntok++] = TOK_MATCH | ((uint32_t)len << 16) | (dist - 1);
            pos += len;
        } else {
            tokens[ntok++] = src[pos++];
        }
        if (ntok >= BLOCK || pos >= n) {
            ok = emit_block(bw, tokens, ntok, src, blk_start, pos, pos >= n);
            blk_start = pos;
            ntok = 0;
        }
    }
    if (!ok) return -1;
    return bw.finish(dst);
}

// Decode the packed candidate format (ops/match_finder.py round-4 D2H cut)
// back into the uint16-per-position array: 2-bit class stream (n/4 bytes;
// 0=none, 1=repeat-previous, 2=exception, 3=dist 1) followed by the
// per-64-position exception stream (16 uint16 slots per chunk, n/2 bytes).
// Exceptions past a chunk's 16-slot budget were degraded by the packer to
// class 1 (repeat-previous) — a stale-distance *guess* that the parser's
// byte-compare verification can only turn into a found match, never
// corruption.
static void unpack_candidates(const uint8_t* packed, int64_t n,
                              uint16_t* out) {
    // 2-bit classes (n/4 bytes): 0 none, 1 repeat-previous, 2 exception,
    // 3 dist 1; then per-64-position chunk, 16 u16 exception slots (n/2 B)
    const uint8_t* cls2 = packed;
    const uint8_t* exc8 = packed + n / 4;
    uint16_t prev = 0;
    for (int64_t c = 0; c < n / 64; c++) {
        const uint8_t* slot = exc8 + c * 32;  // 16 u16 LE per chunk
        int used = 0;
        for (int64_t j = 0; j < 64; j++) {
            int64_t p = c * 64 + j;
            uint32_t cls = (cls2[p >> 2] >> ((p & 3) * 2)) & 3;
            uint16_t d;
            if (cls == 0) d = 0;
            else if (cls == 1) d = prev;
            else if (cls == 2) {
                d = (uint16_t)(slot[used * 2] | (slot[used * 2 + 1] << 8));
                used++;
            } else d = 1;
            out[p] = d;
            if (d) prev = d;
        }
    }
}

int64_t qz_deflate_candidates_packed(const uint8_t* src, int64_t n,
                                     const uint8_t* packed, int64_t packed_n,
                                     uint8_t* dst, int64_t cap, int level) {
    // packed_n: padded candidate width (multiple of 64, >= n)
    if (n == 0) return qz_deflate_candidates(src, n, nullptr, dst, cap, level);
    static thread_local std::vector<uint16_t> cand;
    if ((int64_t)cand.size() < packed_n) cand.resize(packed_n);
    unpack_candidates(packed, packed_n, cand.data());
    return qz_deflate_candidates(src, n, cand.data(), dst, cap, level);
}

// Compress src[0..n) into a complete raw-deflate stream (final block has
// BFINAL=1).  level 1..9.  Returns bytes written or -1 (insufficient cap).
int64_t qz_deflate_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int level) {
    if (level < 1) level = 1;
    if (level > 9) level = 9;
    if (level >= 3) return zlib_deflate_raw(src, n, dst, cap, level);
    BitWriter bw(dst, cap);
    if (n == 0) {
        // empty: one static block, EOB only
        bw.put(1 | (1 << 1), 3);
        bw.put(g_static.ll_code[256], g_static.ll_len[256]);
        return bw.finish(dst);
    }

    constexpr int64_t BLOCK = 1 << 14;  // token-block granularity
    const int64_t ntok_cap = BLOCK + 16;
    const LevelParams lp = g_levels[level];
    const bool need_prev = lp.chain > 1;
    Scratch& sc = g_scratch;
    if (!sc.ensure(n, ntok_cap, need_prev)) return -1;
    uint32_t* tokens = sc.tokens;

    Tokenizer tk{src, n, sc.head, need_prev ? sc.prev : nullptr,
                 sc.base, lp};
    sc.base += n + 1;  // stamp window for the NEXT call
    const bool lazy = lp.lazy != 0;
    // fast levels: skip-ahead through incompressible runs (libdeflate-style
    // acceleration); insert every step anyway so later matches stay findable
    const bool fast = level <= 3;

    int64_t pos = 0;
    int64_t blk_start = 0;
    int64_t ntok = 0;
    int64_t miss_run = 0;
    // matches must not read past n; word-compare path reads up to 8 past
    // the match end, so stop match search 8 early and finish with literals
    const int64_t match_pos_limit = n - 12 > 0 ? n - 12 : 0;
    bool ok = true;

    while (pos < n && ok) {
        if (pos < match_pos_limit) {
            uint32_t dist = 0;
            int len = tk.find_insert(pos, n - 8, &dist, 3);
            // skip tiny far matches (same heuristic as zlib TOO_FAR)
            if (len == 3 && dist > 4096) len = 0;
            int64_t body_from = pos + 1;
            if (len >= 3 && lazy) {
                // iterative lazy deferral (zlib's prev_match loop): keep
                // sliding forward while the next position matches longer
                while (pos + 1 < match_pos_limit && ntok < ntok_cap - 8) {
                    uint32_t dist2 = 0;
                    int len2 = tk.find_insert(pos + 1, n - 8, &dist2,
                                              len + 1);
                    if (len2 <= len) {
                        body_from = pos + 2;  // probe inserted pos+1
                        break;
                    }
                    tokens[ntok++] = src[pos];  // literal, defer to pos+1
                    pos += 1;
                    body_from = pos + 1;
                    len = len2;
                    dist = dist2;
                }
            }
            if (len >= 3) {
                miss_run = 0;
                tokens[ntok++] =
                    TOK_MATCH | ((uint32_t)len << 16) | (dist - 1);
                int64_t stop = pos + len;
                if (stop > match_pos_limit) stop = match_pos_limit;
                if (fast) {
                    // sparse body insertion (libdeflate-style): denser at
                    // the match head where future references land
                    for (int64_t p2 = body_from; p2 < stop; p2 += 3)
                        tk.insert(p2);
                } else {
                    for (int64_t p2 = body_from; p2 < stop; p2++)
                        tk.insert(p2);
                }
                pos += len;
            } else {
                tokens[ntok++] = src[pos++];
                if (fast) {
                    // accelerate through incompressible stretches: after 32
                    // misses emit literals in pairs, after 128 in fours
                    miss_run++;
                    int skip = miss_run >= 256 ? 7
                             : miss_run >= 128 ? 3 : miss_run >= 32 ? 1 : 0;
                    while (skip-- > 0 && pos < match_pos_limit
                           && ntok < ntok_cap - 8) {
                        tk.insert(pos);
                        tokens[ntok++] = src[pos++];
                    }
                }
            }
        } else {
            tokens[ntok++] = src[pos++];
        }
        if (ntok >= BLOCK || pos >= n) {
            ok = emit_block(bw, tokens, ntok, src, blk_start, pos, pos >= n);
            blk_start = pos;
            ntok = 0;
        }
    }

    if (!ok) return -1;
    return bw.finish(dst);
}

// ---------------------------------------------------------------------------
// inflate
// ---------------------------------------------------------------------------
namespace {
struct BitReader {
    const uint8_t* ip;
    const uint8_t* iend;
    uint64_t acc = 0;
    int nbits = 0;
    bool fail = false;

    BitReader(const uint8_t* src, int64_t n) : ip(src), iend(src + n) {}

    inline void refill() {
        if (ip + 8 <= iend) {
            acc |= read64(ip) << nbits;
            int take = (63 - nbits) >> 3;
            ip += take;
            nbits += take << 3;
            // zero bits beyond nbits so the stored-block path may read
            // directly from ip once the accumulator drains
            acc &= (((uint64_t)1 << nbits) - 1);
        } else {
            while (nbits <= 56 && ip < iend) {
                acc |= (uint64_t)(*ip++) << nbits;
                nbits += 8;
            }
        }
    }
    inline uint32_t peek(int bits) { return (uint32_t)(acc & ((1u << bits) - 1)); }
    inline void consume(int bits) {
        if (bits > nbits) { fail = true; nbits = 0; acc = 0; return; }
        acc >>= bits;
        nbits -= bits;
    }
    inline uint32_t get(int bits) {
        if (nbits < bits) refill();
        uint32_t v = (uint32_t)(acc & (((uint64_t)1 << bits) - 1));
        consume(bits);
        return v;
    }
    inline void align_byte() { consume(nbits & 7); }
    // bytes consumed from the stream, accounting for unread accumulator bits
    int64_t consumed(const uint8_t* src) const {
        return (ip - src) - (nbits >> 3);
    }
};

// two-level decode table with fused payload entries (libdeflate-style):
//   bit31: subtable link  [30-24]=sub_bits, [23-0]=offset
//   bit30: literal        [15-8]=byte, [4-0]=codelen
//   bit29: end-of-block   [4-0]=codelen
//   bit28: plain symbol   [19-8]=sym, [4-0]=codelen (code-length table)
//   else : len/dist       [24-20]=extra_bits, [19-5]=base, [4-0]=codelen
// 0xFFFFFFFF marks invalid (unused code).
enum TabKind { TAB_LITLEN, TAB_DIST, TAB_PLAIN };

inline uint32_t make_entry(TabKind kind, int sym, int codelen) {
    switch (kind) {
    case TAB_LITLEN:
        if (sym < 256) return 0x40000000u | ((uint32_t)sym << 8) | codelen;
        if (sym == 256) return 0x20000000u | codelen;
        if (sym > 285) return 0xFFFFFFFFu;
        return ((uint32_t)LEN_EB[sym - 257] << 20)
             | ((uint32_t)LEN_BASE[sym - 257] << 5) | codelen;
    case TAB_DIST:
        if (sym > 29) return 0xFFFFFFFFu;
        return ((uint32_t)DIST_EB[sym] << 20)
             | (DIST_BASE[sym] << 5) | codelen;
    default:
        return 0x10000000u | ((uint32_t)sym << 8) | codelen;
    }
}

struct HuffTable {
    uint32_t root[1 << 11];
    uint32_t sub[1 << 15];
    int root_bits;
    int nsub = 0;

    // build with subtable pre-sizing
    bool build2(const uint8_t* lens, int n, int rb,
                TabKind kind = TAB_PLAIN) {
        root_bits = rb;
        int bl_count[16] = {0};
        for (int i = 0; i < n; i++) bl_count[lens[i]]++;
        bl_count[0] = 0;
        int64_t left = 1;
        int maxlen = 0, nlive = 0;
        for (int b = 1; b <= 15; b++) {
            left <<= 1;
            left -= bl_count[b];
            if (left < 0) return false;
            if (bl_count[b]) { maxlen = b; nlive += bl_count[b]; }
        }
        if (nlive == 0) return false;
        // incomplete codes are only legal with a single symbol of length 1
        if (left > 0 && !(nlive == 1 && maxlen == 1)) return false;
        uint32_t next_code[16];
        uint32_t code = 0;
        for (int b = 1; b <= 15; b++) {
            code = (code + bl_count[b - 1]) << 1;
            next_code[b] = code;
        }
        std::memset(root, 0xFF, sizeof(uint32_t) << rb);  // invalid marker
        nsub = 0;
        // pre-size subtables: max code length per root prefix
        uint8_t pref_max[1 << 11];
        std::memset(pref_max, 0, 1u << rb);
        {
            uint32_t nc[16];
            std::memcpy(nc, next_code, sizeof(nc));
            for (int i = 0; i < n; i++) {
                int l = lens[i];
                if (!l || l <= rb) { if (l) nc[l]++; continue; }
                uint32_t c = nc[l]++;
                uint32_t r = 0;
                for (int b = 0; b < l; b++)
                    r |= ((c >> b) & 1) << (l - 1 - b);
                uint32_t low = r & ((1u << rb) - 1);
                if (pref_max[low] < l) pref_max[low] = (uint8_t)l;
            }
        }
        // allocate subtables
        int sub_off_for[1 << 11];
        for (uint32_t p = 0; p < (1u << rb); p++) {
            if (pref_max[p]) {
                int sb = pref_max[p] - rb;
                sub_off_for[p] = nsub;
                root[p] = 0x80000000u | ((uint32_t)sb << 24) | nsub;
                int sz = 1 << sb;
                if (nsub + sz > (1 << 15)) return false;
                std::memset(sub + nsub, 0xFF, sizeof(uint32_t) << sb);
                nsub += sz;
            }
        }
        // fill
        for (int i = 0; i < n; i++) {
            int l = lens[i];
            if (!l) continue;
            uint32_t c = next_code[l]++;
            uint32_t r = 0;
            for (int b = 0; b < l; b++) r |= ((c >> b) & 1) << (l - 1 - b);
            uint32_t entry = make_entry(kind, i, l);
            if (l <= rb) {
                for (uint32_t idx = r; idx < (1u << rb); idx += (1u << l))
                    root[idx] = entry;
            } else {
                int sb = (root[r & ((1u << rb) - 1)] >> 24) & 0x7F;
                int off = sub_off_for[r & ((1u << rb) - 1)];
                uint32_t high = r >> rb;
                for (uint32_t idx = high; idx < (1u << sb);
                     idx += (1u << (l - rb)))
                    sub[off + idx] = entry;
            }
        }
        // single-symbol length-1 incomplete code: fill the hole with the
        // same symbol so a stray bit still decodes deterministically
        if (left > 0) {
            for (uint32_t p = 0; p < (1u << rb); p++)
                if (root[p] == 0xFFFFFFFFu) {
                    for (uint32_t q = 0; q < (1u << rb); q++)
                        if (root[q] != 0xFFFFFFFFu) { root[p] = root[q]; break; }
                }
        }
        return true;
    }

    // raw table lookup from accumulator bits; 0xFFFFFFFF on invalid
    inline uint32_t lookup(uint64_t acc) const {
        uint32_t e = root[acc & ((1u << root_bits) - 1)];
        if (e & 0x80000000u) {
            if (e == 0xFFFFFFFFu) return e;
            int sb = (e >> 24) & 0x7F;
            e = sub[(e & 0xFFFFFF) +
                    (uint32_t)((acc >> root_bits) & (((uint64_t)1 << sb) - 1))];
        }
        return e;
    }

    // decode one PLAIN symbol (code-length table); returns sym or -1
    inline int decode(BitReader& br) {
        if (br.nbits < 15) br.refill();
        uint32_t e = lookup(br.acc);
        if (e == 0xFFFFFFFFu) return -1;
        int bits = e & 31;
        if (bits > br.nbits) { br.fail = true; return -1; }
        br.consume(bits);
        return (int)((e >> 8) & 0xFFF);
    }
};

struct FixedTables {
    HuffTable ll, d;
    FixedTables() {
        uint8_t lens[288];
        for (int i = 0; i < 288; i++)
            lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        ll.build2(lens, 288, 10, TAB_LITLEN);
        // the fixed dist code is defined over 32 five-bit codes; symbols
        // 30-31 are invalid-if-used (RFC1951 3.2.6) and map to 0xFFFFFFFF
        uint8_t dl[32];
        for (int i = 0; i < 32; i++) dl[i] = 5;
        d.build2(dl, 32, 8, TAB_DIST);
    }
};
const FixedTables g_fixed;
}  // namespace

// Inflate a complete raw-deflate stream.  Returns output bytes or a
// negative error; *in_used = compressed bytes consumed; *eof = 1 when the
// final block (BFINAL) was reached.
int64_t qz_inflate(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                   int64_t* in_used, int32_t* eof) {
    BitReader br(src, n);
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    *eof = 0;

    HuffTable* dyn_ll = nullptr;
    HuffTable* dyn_d = nullptr;
    auto cleanup = [&]() {
        if (dyn_ll) { std::free(dyn_ll); dyn_ll = nullptr; }
        if (dyn_d) { std::free(dyn_d); dyn_d = nullptr; }
    };

    for (;;) {
        uint32_t bfinal = br.get(1);
        uint32_t btype = br.get(2);
        if (br.fail) { cleanup(); return -1; }

        if (btype == 0) {
            br.align_byte();
            // read LEN/NLEN from the byte-aligned stream
            uint32_t len = br.get(16);
            uint32_t nlen = br.get(16);
            if (br.fail || (len ^ nlen) != 0xFFFF) { cleanup(); return -1; }
            if (op + len > oend) { cleanup(); return -2; }
            for (uint32_t k = 0; k < len; k++) {
                if (br.nbits >= 8) {
                    op[k] = (uint8_t)br.acc;
                    br.consume(8);
                } else if (br.ip < br.iend) {
                    op[k] = *br.ip++;
                } else { cleanup(); return -1; }
            }
            op += len;
        } else if (btype == 1 || btype == 2) {
            const HuffTable* tll;
            const HuffTable* td;
            if (btype == 1) {
                tll = &g_fixed.ll;
                td = &g_fixed.d;
            } else {
                uint32_t hlit = br.get(5) + 257;
                uint32_t hdist = br.get(5) + 1;
                uint32_t hclen = br.get(4) + 4;
                if (br.fail || hlit > 286 || hdist > 30) { cleanup(); return -1; }
                uint8_t cl_lens[19] = {0};
                for (uint32_t i = 0; i < hclen; i++)
                    cl_lens[CL_ORDER[i]] = (uint8_t)br.get(3);
                if (br.fail) { cleanup(); return -1; }
                HuffTable cl;
                if (!cl.build2(cl_lens, 19, 7)) { cleanup(); return -1; }
                uint8_t lens[316];
                uint32_t got = 0;
                while (got < hlit + hdist) {
                    int s = cl.decode(br);
                    if (s < 0 || br.fail) { cleanup(); return -1; }
                    if (s < 16) lens[got++] = (uint8_t)s;
                    else if (s == 16) {
                        if (got == 0) { cleanup(); return -1; }
                        uint32_t r = 3 + br.get(2);
                        if (got + r > hlit + hdist) { cleanup(); return -1; }
                        uint8_t v = lens[got - 1];
                        while (r--) lens[got++] = v;
                    } else if (s == 17) {
                        uint32_t r = 3 + br.get(3);
                        if (got + r > hlit + hdist) { cleanup(); return -1; }
                        while (r--) lens[got++] = 0;
                    } else {
                        uint32_t r = 11 + br.get(7);
                        if (got + r > hlit + hdist) { cleanup(); return -1; }
                        while (r--) lens[got++] = 0;
                    }
                }
                if (!dyn_ll) {
                    dyn_ll = (HuffTable*)std::malloc(sizeof(HuffTable));
                    dyn_d = (HuffTable*)std::malloc(sizeof(HuffTable));
                    if (!dyn_ll || !dyn_d) { cleanup(); return -1; }
                }
                uint8_t dlens[30] = {0};
                std::memcpy(dlens, lens + hlit, hdist);
                if (!dyn_ll->build2(lens, hlit, 10, TAB_LITLEN)) {
                    cleanup(); return -1;
                }
                bool d_ok = dyn_d->build2(dlens, 30, 8, TAB_DIST);
                if (!d_ok) {
                    // all-zero dist lens: legal when the block has no
                    // matches; mark with nsub = -1 sentinel
                    int any = 0;
                    for (int i = 0; i < (int)hdist; i++) any |= dlens[i];
                    if (any) { cleanup(); return -1; }
                    dyn_d->root_bits = 0;
                }
                tll = dyn_ll;
                td = dyn_d;
            }

            // fused hot loop: one refill covers litlen code+extra (<=20b)
            // plus dist code+extra (<=28b); literals chain up to three per
            // refill.  Output stays inside the fast region so match copies
            // can overshoot by a word.
            uint8_t* out_fast = (oend - dst > 282) ? oend - 282 : dst;
            bool done = false;
            while (!done) {
                br.refill();
                if (br.nbits < 1 && br.ip >= br.iend) { cleanup(); return -1; }
                uint32_t e = tll->lookup(br.acc);
                if (e == 0xFFFFFFFFu) { cleanup(); return -1; }
                if (e & 0x40000000u) {  // literal
                    if (op >= out_fast) {
                        if (op >= oend) { cleanup(); return -2; }
                        *op++ = (uint8_t)(e >> 8);
                        br.consume(e & 31);
                        if (br.fail) { cleanup(); return -1; }
                        continue;
                    }
                    *op++ = (uint8_t)(e >> 8);
                    br.consume(e & 31);
                    // chain two more literals from the same refill
                    for (int k = 0; k < 2; k++) {
                        e = tll->lookup(br.acc);
                        if (e == 0xFFFFFFFFu || !(e & 0x40000000u)
                            || (int)(e & 31) > br.nbits)
                            break;
                        *op++ = (uint8_t)(e >> 8);
                        br.consume(e & 31);
                    }
                    if (br.fail) { cleanup(); return -1; }
                    continue;
                }
                if (e & 0x20000000u) {  // end of block
                    br.consume(e & 31);
                    if (br.fail) { cleanup(); return -1; }
                    done = true;
                    break;
                }
                // length symbol: fused base+extra from one accumulator view
                {
                    int cl = e & 31;
                    int eb = (e >> 20) & 31;
                    uint32_t len = ((e >> 5) & 0x7FFF)
                        + (uint32_t)((br.acc >> cl)
                                     & (((uint64_t)1 << eb) - 1));
                    br.consume(cl + eb);
                    if (td->root_bits == 0 || br.fail) { cleanup(); return -1; }
                    uint32_t e2 = td->lookup(br.acc);
                    if (e2 == 0xFFFFFFFFu || (e2 & 0x78000000u)) {
                        cleanup(); return -1;
                    }
                    int cl2 = e2 & 31;
                    int eb2 = (e2 >> 20) & 31;
                    uint32_t dist = ((e2 >> 5) & 0x7FFF)
                        + (uint32_t)((br.acc >> cl2)
                                     & (((uint64_t)1 << eb2) - 1));
                    br.consume(cl2 + eb2);
                    if (br.fail) { cleanup(); return -1; }
                    if ((int64_t)dist > op - dst) { cleanup(); return -1; }
                    const uint8_t* mp = op - dist;
                    if (dist >= 8 && op < out_fast) {
                        uint8_t* o = op;
                        int64_t l = len;
                        while (l > 0) {      // overshoot-safe in fast region
                            std::memcpy(o, mp, 8);
                            o += 8; mp += 8; l -= 8;
                        }
                        op += len;
                    } else {
                        if (op + len > oend) { cleanup(); return -2; }
                        for (uint32_t k = 0; k < len; k++) op[k] = mp[k];
                        op += len;
                    }
                }
            }
        } else {
            cleanup();
            return -1;
        }

        if (bfinal) { *eof = 1; break; }
        if (br.ip >= br.iend && br.nbits == 0) break;  // truncated stream
    }
    *in_used = br.consumed(src);
    cleanup();
    return op - dst;
}

// ---------------------------------------------------------------------------
// Batch Huffman/header build for the device (TPU) encoder's hybrid split:
// the device computes per-block litlen/dist histograms (K1), this routine
// builds true length-limited Huffman tables + the RLE-compressed dynamic
// header bit-fields + the block-mode decision on the host (the 286-entry
// build is microseconds), and the device packs the bitstream (K2).  Plays
// the role of the QAT ASIC's dynamic-Huffman header generation
// (reference src/qatzip_utils.c:284-341 selects CPA_DC_HT_FULL_DYNAMIC).
//
// Per block b (row-major batch arrays):
//   freq_ll [B*286], freq_d [B*30]  symbol histograms (EOB already counted)
//   blk_len [B]                     uncompressed block size
// Outputs:
//   mode [B]             0=dynamic 1=static 2=stored
//   ll_len/ll_code [B*286], d_len/d_code [B*30]   emission tables
//       (mode-selected; codes bit-reversed for LSB-first packing)
//   hdr_vals [B*hmax] u32, hdr_nbits [B*hmax]     header bit-fields
//       (first field = BFINAL|BTYPE; unused fields have nbits 0)
//   est_bits [B]         exact total block bits incl. header + EOB
// Returns 0, or -1 when hmax is too small for some header.
int qz_huff_build_batch(const uint32_t* freq_ll, const uint32_t* freq_d,
                        const int32_t* blk_len, int B, int allow_dynamic,
                        int64_t bit_capacity, int hmax,
                        int32_t* mode_o,
                        int32_t* ll_len_o, int32_t* ll_code_o,
                        int32_t* d_len_o, int32_t* d_code_o,
                        uint32_t* hdr_vals, int32_t* hdr_nbits,
                        int64_t* est_bits) {
    for (int b = 0; b < B; b++) {
        const uint32_t* fll = freq_ll + (size_t)b * 286;
        const uint32_t* fd = freq_d + (size_t)b * 30;
        int32_t* oll_len = ll_len_o + (size_t)b * 286;
        int32_t* oll_code = ll_code_o + (size_t)b * 286;
        int32_t* od_len = d_len_o + (size_t)b * 30;
        int32_t* od_code = d_code_o + (size_t)b * 30;
        uint32_t* hv = hdr_vals + (size_t)b * hmax;
        int32_t* hn = hdr_nbits + (size_t)b * hmax;
        std::memset(hv, 0, sizeof(uint32_t) * hmax);
        std::memset(hn, 0, sizeof(int32_t) * hmax);

        uint8_t ll_len[286], d_len[30];
        uint16_t ll_code[286], d_code[30];
        build_huffman(fll, 286, 15, ll_len, ll_code);
        build_huffman(fd, 30, 15, d_len, d_code);
        int nd = 0;
        for (int i = 0; i < 30; i++) if (d_len[i]) nd++;
        if (nd == 0) { d_len[0] = 1; d_code[0] = 0; }

        int hlit = 286;
        while (hlit > 257 && ll_len[hlit - 1] == 0) hlit--;
        int hdist = 30;
        while (hdist > 1 && d_len[hdist - 1] == 0) hdist--;

        uint8_t all[316];
        std::memcpy(all, ll_len, hlit);
        std::memcpy(all + hlit, d_len, hdist);
        ClSym cls[316];
        int ncls = rle_code_lengths(all, hlit + hdist, cls);
        uint32_t freq_cl[19] = {0};
        for (int i = 0; i < ncls; i++) freq_cl[cls[i].sym]++;
        uint8_t cl_len[19];
        uint16_t cl_code[19];
        build_huffman(freq_cl, 19, 7, cl_len, cl_code);
        int hclen = 19;
        while (hclen > 4 && cl_len[CL_ORDER[hclen - 1]] == 0) hclen--;

        // exact bit costs
        int64_t hdr_bits = 3 + 5 + 5 + 4 + 3 * hclen;
        for (int i = 0; i < ncls; i++)
            hdr_bits += cl_len[cls[i].sym] + cls[i].extra_bits;
        int64_t sym_dyn = 0, sym_static = 0, extra = 0;
        for (int i = 0; i < 286; i++) {
            if (!fll[i]) continue;
            sym_dyn += (int64_t)fll[i] * ll_len[i];
            sym_static += (int64_t)fll[i] * g_static.ll_len[i];
        }
        for (int c = 0; c < 29; c++)
            extra += (int64_t)fll[257 + c] * LEN_EB[c];
        for (int c = 0; c < 30; c++) {
            if (!fd[c]) continue;
            sym_dyn += (int64_t)fd[c] * d_len[c];
            sym_static += (int64_t)fd[c] * 5;
            extra += (int64_t)fd[c] * DIST_EB[c];
        }
        int64_t dyn_bits = hdr_bits + sym_dyn + extra;
        int64_t static_bits = 3 + sym_static + extra;
        int64_t len = blk_len[b];
        int nstored = len ? (int)((len + 65534) / 65535) : 1;
        int64_t stored_bits = 8 * (5 * (int64_t)nstored + len);

        int mode;
        if (allow_dynamic && dyn_bits <= static_bits
            && dyn_bits <= stored_bits && dyn_bits <= bit_capacity)
            mode = 0;
        else if (static_bits <= stored_bits && static_bits <= bit_capacity)
            mode = 1;
        else
            mode = 2;
        mode_o[b] = mode;

        if (mode == 0) {
            // header fields: BFINAL|BTYPE, HLIT, HDIST, HCLEN, cl lens, RLE
            int m = 0;
            auto putf = [&](uint32_t v, int nb) {
                if (m < hmax) { hv[m] = v; hn[m] = nb; }
                m++;
            };
            putf(1u | (2u << 1), 3);
            putf((uint32_t)(hlit - 257), 5);
            putf((uint32_t)(hdist - 1), 5);
            putf((uint32_t)(hclen - 4), 4);
            for (int i = 0; i < hclen; i++) putf(cl_len[CL_ORDER[i]], 3);
            for (int i = 0; i < ncls; i++) {
                putf(cl_code[cls[i].sym], cl_len[cls[i].sym]);
                if (cls[i].extra_bits)
                    putf(cls[i].extra_val, cls[i].extra_bits);
            }
            if (m > hmax) return -1;
            for (int i = 0; i < 286; i++) {
                oll_len[i] = ll_len[i];
                oll_code[i] = ll_code[i];
            }
            for (int i = 0; i < 30; i++) {
                od_len[i] = d_len[i];
                od_code[i] = d_code[i];
            }
            est_bits[b] = dyn_bits;
        } else if (mode == 1) {
            hv[0] = 1u | (1u << 1);
            hn[0] = 3;
            for (int i = 0; i < 286; i++) {
                oll_len[i] = g_static.ll_len[i];
                oll_code[i] = g_static.ll_code[i];
            }
            for (int i = 0; i < 30; i++) {
                od_len[i] = g_static.d_len[i];
                od_code[i] = g_static.d_code[i];
            }
            est_bits[b] = static_bits;
        } else {
            // stored: emitted fully on the host; device output ignored
            std::memset(oll_len, 0, sizeof(int32_t) * 286);
            std::memset(oll_code, 0, sizeof(int32_t) * 286);
            std::memset(od_len, 0, sizeof(int32_t) * 30);
            std::memset(od_code, 0, sizeof(int32_t) * 30);
            est_bits[b] = stored_bits;
        }
    }
    return 0;
}

}  // extern "C"
